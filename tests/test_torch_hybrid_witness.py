"""The f32 witness (``launch/witness.py``) on reduced jamba-v0.1-52b,
bf16: the two ``test_f32_witness`` cases of ``tests/test_torch_hybrid.py``
that took the most time (147.5 s and 132.7 s on the CPU), in a file of
their own so that the suite's workers share the load. The same test and
tolerances; rwkv6-3b's cases stay there and call
:func:`check_f32_witness` too.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.launch.serve import build_model

JAMBA = "jamba-v0.1-52b"
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_f32_witness(arch, scale, monkeypatch):
    """``launch/witness.py`` on reduced bf16 models (chip_smoke.py's
    witness on the served ones): on the CPU the kernels' policy runs the
    plain versions, so every layer and every call's logits lie exactly
    as far from f32 as the plain path's (ratio 1). With every compressed
    product through the kernels' policy scaled by 1 + 2^-6 (a kernel a
    few bf16 steps off) some ratio exceeds chip_smoke.py's WITNESS_C."""
    from repro_torch.core.nmweight import NMWeight
    from repro_torch.launch import witness
    from repro_torch.models import common

    _, lm = build_model(arch, full=False, kernels=True, dtype=torch.bfloat16,
                        seed=0, device="cpu")
    if scale is not None:
        plain = common.linear_apply

        def off(weight, x, **kw):
            y = plain(weight, x, **kw)
            if (isinstance(weight, NMWeight)
                    and weight.kernel_policy.mode == "auto"):
                y = y * scale
            return y
        monkeypatch.setattr(common, "linear_apply", off)
    rows = witness.f32_witness(lm, slots=2, prefill_len=8, steps=4)
    assert len(rows) == 5 * len(lm.layers) + 5
    assert all(r[0] == "layer" for r in rows[:-5])
    assert [r[1] for r in rows[-5:]] == ["prefill logits"] + [
        f"decode {i} logits" for i in range(1, 5)]
    ratios = [witness.ratio(kern, base) for _, _, kern, base in rows]
    if scale is None:
        assert ratios == [1.0] * len(rows)
    else:
        assert max(ratios) > _chip_smoke().WITNESS_C
    assert all(m.kernel_policy.mode == "auto" and m.compute_dtype is None
               for m in lm.modules() if getattr(m, "nm", None) is not None)




@pytest.mark.parametrize("arch", [JAMBA])
@pytest.mark.parametrize("scale", [None, 1 + 2 ** -6],
                         ids=["kernels", "kernels-off"])
def test_f32_witness(arch, scale, monkeypatch):
    check_f32_witness(arch, scale, monkeypatch)
