"""Kernel launch counts, read by kernel name.

Every kernel wrapper adds one to its module's ``launches`` dict (by scheme,
a gather's by ``fm.launch_key`` of scheme and form) where it launches its
kernel.  This module sets those counts to 0, reads them, and names the CUDA
kernel a step launches, for ``chip_smoke.py`` and the tools that count a
run's launches (``tools/fuzz_torch.py``, ``tools/soak_torch.py``).
"""

from __future__ import annotations

from ..ops import dense_fir as df
from ..ops import fir_matmul as fm
from ..ops import streamed_fir as sf
from ..ops import tiled_fir as tf

#: every kernel module, by the geometry it launches
MODULES = {"tiled": tf, "streamed": sf, "dense": df, "gather": fm}

#: the single-stream route's gather launches: the rows form on f32 samples
CORE_GATHER = "gather_fir_f32_kernel<float> (core rows form)"


def reset_launches() -> None:
    """Every kernel module's launch counts to 0."""
    for module in MODULES.values():
        module.launches.update(dict.fromkeys(module.launches, 0))


def launch_counts() -> dict:
    """The nonzero launch counts, by geometry and scheme (a gather's by
    ``fm.launch_key`` of scheme and form)."""
    return {k: {s: n for s, n in m.launches.items() if n}
            for k, m in MODULES.items() if any(m.launches.values())}


def n_accum_of(step) -> int:
    """The fixed kernels' accumulator count of a step: its weight column
    sets, or a gather's tap rows an output."""
    if step.kernel == "gather":
        return step.w[0].shape[1] if step.w[0].ndim == 3 else 1
    return step.kernel_kw.get("n_accum", 1)


def kernel_name(kernel: str, scheme: str, n_accum: int = 1,
                form: str = "rows", kO: int = 0) -> str:
    """The CUDA kernel a (geometry, resolved scheme, n_accum) launches; a
    gather's in its form, with its template arguments (the samples int16;
    the rows form's kO = M / 8 outputs a warp)."""
    if kernel == "gather":
        if form == "band":
            return ("gather_fir_f64mma_kernel<short>" if scheme == "highest"
                    else f"gather_fir_fixed_band_kernel<{n_accum}>")
        if form == "stream":
            return ("gather_fir_f64mma_stream_kernel<short>"
                    if scheme == "highest"
                    else f"gather_fir_fixed_stream_kernel<{n_accum}>")
        return (f"gather_fir_f32_kernel<short, {kO}>" if scheme == "highest"
                else f"gather_fir_fixed_kernel<{n_accum}, {kO}>")
    if scheme == "fixed":
        return f"{kernel}_fir_fixed_kernel<{n_accum}>"
    suffix = {"highest": "f32", "int8": "int8", "split5": "split5"}[scheme]
    return f"{kernel}_fir_{suffix}_kernel"


def step_kernel(step) -> tuple:
    """((geometry, launch key), kernel name) of a step's launches; a CPU
    gather step (no plan) is named by the plan a CUDA step would make."""
    form, kO, key = "rows", 0, step.scheme
    if step.kernel == "gather":
        plan = step.kernel_kw["plan"] or fm.gather_plan(
            step.w[1].cpu().numpy(), step.w[0].shape[-1],
            n_accum=n_accum_of(step) if step.scheme == "fixed" else None)
        form, kO = plan.form, plan.outputs // 8
        key = fm.launch_key(step.scheme, form)
    return (step.kernel, key), kernel_name(step.kernel, step.scheme,
                                           n_accum_of(step), form, kO)


def count_launches(names: dict) -> dict:
    """The nonzero launch counts by kernel name (``names``: (geometry,
    launch key) -> name; a count it does not name goes under
    "geometry/key")."""
    out = {}
    for geometry, module in MODULES.items():
        for key, n in module.launches.items():
            if n:
                name = names.get((geometry, key), f"{geometry}/{key}")
                out[name] = out.get(name, 0) + n
    return out
