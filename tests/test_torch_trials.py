"""The design-trial tools of the port's CUDA kernels stay honest: every
textual variant of `tools/torch_indep_trials.py` (B3 / B4),
`tools/torch_mega_trials.py` (B1 / B2), `tools/torch_coherent_trials.py`
(B5), `tools/torch_dda_trials.py` (D1) and `tools/torch_diff_trials.py`
(D3) still applies to the committed source and changes it, so a variant
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
                                       "torch_coherent_trials", "torch_dda_trials",
                                       "torch_diff_trials")
         for variant in _tool(tool).VARIANTS if variant != "committed"]


@pytest.mark.parametrize("tool, variant", CASES, ids=[f"{t}:{v}" for t, v in CASES])
def test_trial_variant_applies_and_differs(tool, variant):
    mod = _tool(tool)
    committed = mod.variant_source("committed")
    src = mod.variant_source(variant)
    assert src != committed
    assert "extern \"C\" int vt_" in src          # the launcher interface stays


@pytest.mark.parametrize("tool, launcher", [("torch_dda_trials", "vt_dda_parent"),
                                            ("torch_diff_trials", "vt_diff_bwd_parent")])
def test_parent_variant_keeps_the_committed_launchers(tool, launcher):
    """The parent design is added beside the committed kernels, with its own
    launcher, so one library times both."""
    mod = _tool(tool)
    src = mod.variant_source("parent")
    assert f'extern "C" int {launcher}(' in src
    assert src.count(mod.LAUNCHER) == 1
    assert mod.variant_source("committed") in src.replace(mod.PARENT_SOURCE + "\n", "")
