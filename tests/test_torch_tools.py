"""The kernel-variant machinery of the ablation tools, on the CPU.

``tools/{f32,split5,dense,int8}_ablate.py`` build their variants
as text edits of a header of ``speex_resampler_tpu_torch/csrc/``
(``tools/_variants.py``).  Every edit must still find its text in the
header as it stands, or the tool fails on the card; and the loader pointed
at an edited copy must name another library, so no stale build loads.
Nothing here compiles or launches a kernel.
"""

import importlib
import shutil

import pytest

from speex_resampler_tpu_torch.ops import _build

TOOLS = ["f32_ablate", "split5_ablate", "dense_ablate", "int8_ablate"]


@pytest.mark.parametrize("tool", TOOLS)
def test_variant_edits_apply(tool):
    """Each variant's edits apply to the shipped header, and each changes
    it (the tool's unedited baseline excepted)."""
    variants = importlib.import_module("tools._variants")
    mod = importlib.import_module(f"tools.{tool}")
    text = (variants.CSRC / mod.HEADER).read_text()
    assert mod.VARIANTS
    for name, (edits, *also, _) in mod.VARIANTS.items():
        out = variants.patched(text, edits, name)
        others = also[0] if also else {}
        for file, file_edits in others.items():
            src = (variants.CSRC / file).read_text()
            assert variants.patched(src, file_edits, name) != src, name
        assert (out == text) == (not edits), name or others


def test_variant_edit_missing_raises():
    variants = importlib.import_module("tools._variants")
    with pytest.raises(AssertionError, match="not found"):
        variants.patched("int a;", {"int b;": "int c;"}, "probe")


def test_use_csrc_names_another_library(tmp_path):
    """An edited header gives another library name; a copy without a
    header (an earlier checkout's) builds without it; pointing back at the
    package's csrc/ gives the package's library name again."""
    own = _build._CSRC
    name = _build.lib_path()
    copy = tmp_path / "csrc"
    shutil.copytree(own, copy)
    try:
        _build.use_csrc(copy)
        assert _build.lib_path() == name
        f32 = copy / "f32_fir.cuh"
        f32.write_text(f32.read_text() + "\n// edited\n")
        assert _build.lib_path() != name
        f32.unlink()
        _build.use_csrc(copy)
        assert [h.name for h in _build._HEADERS] == [
            "fir_common.cuh", "split5_wgmma.cuh", "int8_wgmma.cuh"]
    finally:
        _build.use_csrc(own)
    assert _build.lib_path() == name and _build._CSRC == own
