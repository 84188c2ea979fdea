"""The port's ``configs/shapes.py`` against the JAX package's, field for
field: the shape table, and the long-context variant of every ported
arch's full and smoke config (``compute_dtype`` is a torch dtype on one
side and a JAX one on the other, and is compared by name). Four full
configs correct the reference's ``source``, whose widths are the same."""

import dataclasses

import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro_torch.configs import registry as tregistry
from repro_torch.configs import shapes as tshapes
from repro_torch.models import transformer as tT
from test_torch_transformer import ARCHS, tokens, vision

# arch -> (the reference's source, the port's): the reference names another
# model of the family (qwen3, granite, llama-3.2-vision) or no real
# identifier (kimi)
SOURCE_FIXES = {
    "qwen3-1.7b": ("hf:Qwen/Qwen3-8B", "hf:Qwen/Qwen3-1.7B"),
    "granite-moe-3b-a800m": ("hf:ibm-granite/granite-3.0-1b-a400m-base",
                             "hf:ibm-granite/granite-3.0-3b-a800m-base"),
    "kimi-k2-1t-a32b": ("arXiv:2501.kimi2", "hf:moonshotai/Kimi-K2-Base"),
    "llama-3.2-vision-90b": ("hf:meta-llama/Llama-3.2-11B-Vision",
                             "hf:meta-llama/Llama-3.2-90B-Vision"),
}


def _fields(cfg) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["compute_dtype"] = str(out["compute_dtype"]).split(".")[-1].replace("'>", "")
    return out


def test_shapes_table_matches_jax():
    assert tshapes.LONG_WINDOW == jshapes.LONG_WINDOW
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, shape in jshapes.SHAPES.items():
        assert dataclasses.asdict(tshapes.SHAPES[name]) == dataclasses.asdict(shape)


@pytest.mark.parametrize("getter", ["get", "get_smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_long_context_variant_matches_jax(arch, getter):
    jcfg = getattr(jregistry, getter)(arch)
    tcfg = getattr(tregistry, getter)(arch)
    if getter == "get" and arch in SOURCE_FIXES:
        assert (jcfg.source, tcfg.source) == SOURCE_FIXES[arch]
        jcfg = dataclasses.replace(jcfg, source=tcfg.source)
    assert _fields(tcfg) == _fields(jcfg)
    assert tshapes.needs_long_variant(tcfg) == jshapes.needs_long_variant(jcfg)
    jlong, tlong = jshapes.long_context_variant(jcfg), tshapes.long_context_variant(tcfg)
    assert _fields(tlong) == _fields(jlong)
    assert tlong.kinds() == jlong.kinds()
    # the variant keeps no global attention layer, and runs in the port
    assert not tshapes.needs_long_variant(tlong)
    if getter == "get_smoke":
        with torch.no_grad():
            logits, _ = tT.forward(tT.init(tlong, device="cpu"), torch.from_numpy(tokens(0)),
                                   tlong, vision=vision(tlong)[1])
        assert bool(torch.isfinite(logits).all())
