"""Kernel launch counts, read by kernel name.

Every kernel wrapper adds one to its module's ``launches`` dict (by scheme,
a gather's by ``fm.launch_key`` of scheme and form, the resident int8
kernel's under "int8_resident") where it launches its kernel.  This module
sets those counts to 0, reads them, the fixed and streamed int8 kernels'
CTA, tile and band counters and the band and stream gathers' CTA,
resident CTA and tile counters (``utils/profiling``), and names the CUDA
kernel a step
launches, for ``chip_smoke.py`` and the tools that count a run's launches
(``tools/fuzz_torch.py``, ``tools/soak_torch.py``).
"""

from __future__ import annotations

from ..ops import dense_fir as df
from ..ops import fir_matmul as fm
from ..ops import streamed_fir as sf
from .profiling import counter_totals, reset_counters

#: every kernel module, by the geometry it launches: the two phase-tiled
#: geometries share one launcher
MODULES = {"tiled": sf, "streamed": sf, "dense": df, "gather": fm}

#: each launcher's counts once, under the launch-count geometry of
#: :func:`step_kernel`
COUNTERS = {"streamed": sf, "dense": df, "gather": fm}

#: the single-stream route's gather launches: the rows form on f32 samples
CORE_GATHER = "gather_fir_f32_kernel<float> (core rows form)"


def reset_launches() -> None:
    """Every kernel module's launch counts to 0, and the port's counters
    (``utils/profiling``: the fixed, streamed int8 and gather launches'
    CTAs and tiles)."""
    for module in COUNTERS.values():
        module.launches.update(dict.fromkeys(module.launches, 0))
    reset_counters()


def fixed_counts() -> tuple:
    """(launches, CTAs, output tiles, band loads) of the phase-tiled fixed
    kernel since the last :func:`reset_launches`, from the port's
    counters."""
    totals = counter_totals()
    return tuple(totals.get(name, 0) for name in (
        sf.FIXED_LAUNCHES, sf.FIXED_CTAS, sf.FIXED_TILES, sf.FIXED_BANDS))


def int8_counts() -> tuple:
    """(launches, CTAs, output tiles, band loads) of the streamed int8
    kernel (K2b, either geometry; not the tiled resident one) since the
    last :func:`reset_launches`, from the port's counters."""
    totals = counter_totals()
    return tuple(totals.get(name, 0) for name in (
        sf.INT8_LAUNCHES, sf.INT8_CTAS, sf.INT8_TILES, sf.INT8_BANDS))


def gather_counts() -> tuple:
    """(launches, CTAs, resident CTAs, output tiles) of the band and stream
    gather kernels, float and fixed, since the last :func:`reset_launches`,
    from the port's counters."""
    totals = counter_totals()
    return tuple(totals.get(name, 0) for name in (
        fm.GATHER_LAUNCHES, fm.GATHER_CTAS, fm.GATHER_RESIDENT,
        fm.GATHER_TILES))


def launch_counts() -> dict:
    """The nonzero launch counts, by launcher ("streamed": both
    phase-tiled geometries) and launch key (a scheme; a gather's
    ``fm.launch_key`` of scheme and form; "int8_resident")."""
    return {k: {s: n for s, n in m.launches.items() if n}
            for k, m in COUNTERS.items() if any(m.launches.values())}


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
    the rows form's kO = M / 8 outputs a warp; a fixed gather has no rows
    form, and its name is the stream kernel's); a tiled int8 launch's
    "rows" form is the resident kernel, its "stream" form the streamed
    one, where the band does not fit shared memory."""
    if kernel == "gather":
        if form == "band":
            return ("gather_fir_f64mma_kernel<short>" if scheme == "highest"
                    else f"gather_fir_fixed_band_kernel<{n_accum}>")
        if form == "stream" or scheme != "highest":
            return ("gather_fir_f64mma_stream_kernel<short>"
                    if scheme == "highest"
                    else f"gather_fir_fixed_stream_kernel<{n_accum}>")
        return f"gather_fir_f32_kernel<short, {kO}>"
    suffix = {"highest": "f32", "int8": "int8", "split5": "split5"}
    if kernel in ("tiled", "streamed"):
        if (kernel, scheme, form) == ("tiled", "int8", "rows"):
            return "tiled_fir_int8_kernel"
        kernel = "streamed"
    if scheme == "fixed":
        return f"{kernel}_fir_fixed_kernel<{n_accum}>"
    return f"{kernel}_fir_{suffix[scheme]}_kernel"


#: a phase-tiled launch whose weight cycle (every phase's weights) is at
#: most this many bytes runs its CTAs (block, row tile) fastest
#: (``csrc/streamed_fir.cu``'s kBlockMajorBytes), else lane tiles fastest
BLOCK_MAJOR_BYTES = 16 << 20


def fixed_instance(step) -> str:
    """The template instance of ``streamed_fir_fixed_kernel`` a fixed
    phase-tiled step (tiled or streamed) launches: its n_accum and its
    CTA order, (block, row tile) fastest ("true") where the planes'
    weight cycle is at most :data:`BLOCK_MAJOR_BYTES`."""
    if (step.kernel, step.scheme) not in (("tiled", "fixed"),
                                          ("streamed", "fixed")):
        raise ValueError(f"not a fixed phase-tiled step: {step.kernel} / "
                         f"{step.scheme}")
    block_major = step.w[0].numel() <= BLOCK_MAJOR_BYTES
    return (kernel_name(step.kernel, "fixed", n_accum_of(step))[:-1]
            + f", {str(block_major).lower()}>")


def step_kernel(step) -> tuple:
    """((launcher, launch key), kernel name) of a step's launches; a CPU
    gather step (no plan) is named by the plan a CUDA step would make.  A
    tiled int8 step whose weights carry a slice count (an int) takes the
    resident kernel (a CPU step always does: its choice is made only for
    CUDA weights, ``sf.int8_launch_weights``), else the streamed one (the
    "stream" form)."""
    form, kO, key, counter = "rows", 0, step.scheme, step.kernel
    if step.kernel in ("tiled", "streamed"):
        counter = "streamed"
        if (step.kernel, step.scheme) == ("tiled", "int8"):
            resident = type(step.w[2]) is int
            form = "rows" if resident else "stream"
            key = "int8_resident" if resident else "int8"
    if step.kernel == "gather":
        plan = step.kernel_kw["plan"] or fm.gather_plan(
            step.w[1].cpu().numpy(), step.w[0].shape[-1],
            n_accum=n_accum_of(step) if step.scheme == "fixed" else None)
        form, kO = plan.form, plan.outputs // 8
        key = fm.launch_key(step.scheme, form)
    return (counter, key), kernel_name(step.kernel, step.scheme,
                                       n_accum_of(step), form, kO)


def count_launches(names: dict) -> dict:
    """The nonzero launch counts by kernel name (``names``: (launcher,
    launch key) -> name, as :func:`step_kernel` gives them; a count it
    does not name goes under "launcher/key")."""
    out = {}
    for counter, module in COUNTERS.items():
        for key, n in module.launches.items():
            if n:
                name = names.get((counter, key), f"{counter}/{key}")
                out[name] = out.get(name, 0) + n
    return out
