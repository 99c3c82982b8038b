"""The design-trial tools of the port's CUDA kernels stay honest: every
textual variant of `tools/torch_indep_trials.py` (B3 / B4),
`tools/torch_mega_trials.py` (B1 / B2) and `tools/torch_coherent_trials.py`
(B5) still applies to the committed source and changes it, so a variant
cannot quietly become the committed kernel or stop being built.  Needs no nvcc: the variants are only
generated here; the tools compile and time them on a card."""

import importlib.util
import pathlib

import pytest

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CASES = [(tool, variant) for tool in ("torch_indep_trials", "torch_mega_trials",
                                       "torch_coherent_trials")
         for variant in _tool(tool).VARIANTS if variant != "committed"]


@pytest.mark.parametrize("tool, variant", CASES, ids=[f"{t}:{v}" for t, v in CASES])
def test_trial_variant_applies_and_differs(tool, variant):
    mod = _tool(tool)
    committed = mod.variant_source("committed")
    src = mod.variant_source(variant)
    assert src != committed
    assert "extern \"C\" int vt_" in src          # the launcher interface stays
