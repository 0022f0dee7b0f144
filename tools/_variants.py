"""Variant builds of the port's kernel library, shared by the ablation tools.

A variant is a copy of ``speex_resampler_tpu_torch/csrc/`` under
``build/<tool>/<name>/`` with text edits of one header.  Building it points
the port's loader at the copy (``ops/_build.use_csrc``), so the wrappers
launch the variant's kernels until the next variant is built.  Before a
tool times a variant it may hold its SASS to pins (:func:`sass_pins`).
"""

from __future__ import annotations

import re
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from speex_resampler_tpu_torch.ops import _build  # noqa: E402

CSRC = ROOT / "speex_resampler_tpu_torch" / "csrc"


def patched(text: str, edits: dict, what: str) -> str:
    """``text`` with every occurrence of each key of ``edits`` replaced by
    its value; raises if a key does not occur (``what`` names the text)."""
    for old, new in edits.items():
        if old not in text:
            raise AssertionError(f"{what}: {old!r} not found")
        text = text.replace(old, new)
    return text


def ptxas(logs: Path, keep) -> str:
    """The ptxas lines of the kernels whose names ``keep`` accepts, from
    the compiler reports (``<source>.log``) in ``logs``."""
    return "; ".join(f"{name}: {'; '.join(lines)}"
                     for log in sorted(logs.glob("*.log"))
                     for name, lines in cs.ptxas_props(log).items()
                     if keep(name))


def build(tool: str, name: str, header: str, edits: dict, keep,
          also: dict | None = None) -> str:
    """Builds and loads the variant ``name`` (``edits`` of ``header``, and
    of each other source file in ``also``: {file: edits}); returns its
    build time and the ptxas lines of the kernels ``keep`` accepts."""
    var = ROOT / "build" / tool / re.sub(r"\W+", "_", name)
    shutil.rmtree(var, ignore_errors=True)
    shutil.copytree(CSRC, var)
    for file, file_edits in {header: edits, **(also or {})}.items():
        path = var / file
        path.write_text(patched(path.read_text(), file_edits,
                                f"{name}, {file}"))
    _build.use_csrc(var)
    t0 = time.time()
    _build.load()
    return (f"build {time.time() - t0:.1f} s: "
            + ptxas(_build.build_dir(), keep))


def sass_pins(name: str, keep, pins: dict, spills=frozenset()) -> list:
    """The loaded variant ``name``'s kernels that ``keep`` accepts against
    ``pins`` ({variant: {kernel: (IGMMA count, least registers)}}: the
    IGMMA count from ``cuobjdump -sass``, registers and spills from the
    ptxas report) and against spilling (but for the variants in
    ``spills``); prints each and returns what is off its pins."""
    counts = cs.gmma_counts(_build.lib_path())
    props = {}
    for log in sorted(_build.build_dir().glob("*.log")):
        for kernel, lines in cs.ptxas_props(log).items():
            text = "; ".join(lines)
            regs = re.search(r"Used (\d+) registers", text)
            spill = [int(n) for n in re.findall(r"(\d+) bytes spill", text)]
            props[kernel] = (int(regs.group(1)) if regs else 0, sum(spill))
    off = []
    for kernel, (regs, spill) in sorted(props.items()):
        if not keep(kernel):
            continue
        igmma = counts.get((kernel, "IGMMA"), 0)
        print(f"   {name}, SASS {kernel}: {regs} registers, {spill} bytes "
              f"spilled, {igmma} IGMMA")
        if spill and name not in spills:
            off.append(f"{kernel} spills {spill} bytes")
        pin = pins.get(name, {}).get(kernel)
        if pin is not None and (igmma != pin[0] or regs < pin[1]):
            off.append(f"{kernel}: {igmma} IGMMA, {regs} registers; pinned "
                       f"{pin[0]} IGMMA, at least {pin[1]} registers")
    missing = set(pins.get(name, {})) - set(props)
    return off + [f"{kernel} not built" for kernel in sorted(missing)]
