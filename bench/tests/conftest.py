"""The benchmark's own tests (``python -m pytest bench/tests``): they put
the checkout's root and ``src`` on the path, and give the card tests a
fixture that skips them without a CUDA card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# smaller sizes of the cells' configurations and traffic, for the CPU
TINY = {
    "resnet": {"model": {"stage_sizes": [1, 1], "width": 8, "num_classes": 10, "image_size": 32},
               "traffic": {"per_rank_batch": 4, "pool": 4, "warmup_steps": 2, "min_steps": 3,
                           "trace_steps": 2}},
    "lm": {"model": {"num_hidden_layers": 2, "hidden_size": 128, "num_attention_heads": 4,
                     "num_key_value_heads": 2, "head_dim": 32, "intermediate_size": 256,
                     "vocab_size": 128},
           "traffic": {"per_rank_batch": 2, "seq_len": 16, "pool": 4, "warmup_steps": 2,
                       "min_steps": 3, "trace_steps": 2}},
}


@pytest.fixture
def cuda():
    """The card, or a skip."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
