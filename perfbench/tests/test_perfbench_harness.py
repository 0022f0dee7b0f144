"""The harness on the CPU: a sound run is correct; the control and each
fault that a cell can have come out not correct; the command refuses a
machine without the cell's card; nothing it loads is JAX's."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from perfbench import manifest, tracing
from perfbench.cell import run_cell
from perfbench.roofline import PEAKS, stage_call_work

from .util import small_cell

SEED = 2**31 + 977
#: window seconds by cell: a few calls each on the CPU
SECONDS = {"stage.q7": 0.3, "stage.q10": 1.2}
STAGE = manifest.entry("stream_stage")
FAULTS = STAGE.FAULTS


def control(config, device):
    return STAGE.control(config, manifest.reference(config), device)


def _run(name="stage.q7", program=None, trace=False):
    return run_cell(small_cell(name), SEED, SECONDS[name], trace,
                    device="cpu", program=program)


@pytest.mark.parametrize("name", ["stage.q7", "stage.q10"])
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 2
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"max_err_lsb", "off_share"}
    assert r["checks"]["max_err_lsb"]["value"] <= 1
    assert set(r["metrics"]) == {"out_rate", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_is_not_correct(fault):
    r = _run(program=FAULTS[fault])
    assert r["correct"] is False
    assert r["failed"] >= 1
    assert r["checks"]["max_err_lsb"]["value"] > 1


@pytest.mark.parametrize("name", ["stage.q7", "stage.q10"])
def test_control_in_bfloat16_is_not_correct(name):
    """The reference in bfloat16, put in the program's place, fails."""
    r = _run(name, program=control)
    assert r["correct"] is False
    assert r["checks"]["max_err_lsb"]["value"] > 10
    assert r["checks"]["off_share"]["value"] > 0.5


def test_reference_in_the_programs_place_at_float64_is_correct():
    """The control's own path is sound: at float64 it is exact."""
    def same(config, device):
        return STAGE.ReferenceStep(config, manifest.reference(config),
                                   device, torch.float64)
    r = _run(program=same)
    assert r["correct"] is True
    assert r["checks"]["max_err_lsb"]["value"] == 0


def test_traced_run_reports_per_layer_metrics_only():
    r = _run(trace=True)
    assert r["correct"] is True
    assert set(r["metrics"]) <= {"fir_roofline", "step_mfu",
                                 "step.other_ms", "device.idle"}
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_readers_on_a_synthetic_trace():
    """Two calls: port kernels of 100 us, a cat of 10 us, a library's
    kernel of 10 us, 30 us idle."""
    work = stage_call_work(128, 8224, 9408, 10240, 2048)
    dev = []
    t = 0.0
    for _ in range(2):
        dev.append(("void at::native::CatArrayBatchedCopy<int>", t,
                    t + 10e-6))
        dev.append(("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm"
                    "_64x64_32x6_nn_align4>(Params)", t + 10e-6, t + 20e-6))
        dev.append(("void (anonymous namespace)::tiled_fir_int8_kernel<3, "
                    "true>(fir::Launch)", t + 20e-6, t + 120e-6))
        t += 150e-6
    host = [("perfbench.call", 0.0, 300e-6), ("aten::cat", 120e-6, 140e-6)]
    v = tracing.TraceView(calls=2, device=dev, host=host, work=work,
                          peaks=PEAKS["H100"])
    read = {m: manifest.reader(m) for m in ("fir_roofline", "step_mfu",
                                            "step.other_ms", "device.idle")}
    least = work.least_s(PEAKS["H100"])
    assert least == work.bytes / PEAKS["H100"]["hbm_bytes_s"]
    assert read["fir_roofline"](v) == pytest.approx(100 * least / 100e-6)
    assert read["step.other_ms"](v) == pytest.approx(0.020)
    assert v.window_s == pytest.approx(270e-6)
    assert read["device.idle"](v) == pytest.approx(100 * 30 / 270)
    assert read["step_mfu"](v) == pytest.approx(
        100 * 2 * work.ops / (270e-6 * 1979e12))
    b = tracing.breakdown(v)
    assert b["device_ops"][0][0].endswith("(fir::Launch)")
    assert len(b["device_ops"]) == 3
    assert b["idle_gaps"] == [["aten::cat", pytest.approx(30e-6)]]
    empty = tracing.TraceView(calls=0, device=[], host=[], work=work,
                              peaks=None)
    assert all(f(empty) is None for f in read.values())


@pytest.mark.parametrize("name,port", [
    ("void (anonymous namespace)::tiled_fir_int8_kernel<3, true>"
     "(fir::Launch, int const*, int, int, int, signed char const*, "
     "float const*, float4)", True),
    ("void (anonymous namespace)::streamed_fir_int8_kernel<4>(fir::Launch, "
     "Origin, signed char const*, float const*, float4)", True),
    ("void fir::dense_fir_f32_kernel(fir::Launch, int, int)", True),
    ("void (anonymous namespace)::gather_fir_f64mma_stream_kernel<short>"
     "(Gather, StreamBand, int)", True),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized"
     "<at::native::(anonymous namespace)::OpaqueType<2u>, unsigned int, 1, "
     "128, 1, 16, 8>(char*, int)", False),
    ("Memcpy DtoD (Device -> Device)", False),
    ("Memset (Device)", False),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas", False),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_32x6_nn_"
     "align4>(Params)", False),
    ("triton_poi_fused_cat_0", False),
])
def test_port_kernels_are_named_by_the_port(name, port):
    """A device operation counts as the port's only where its function
    is one the port's kernel table names; a library's kernel does not."""
    assert tracing.is_port_kernel(name) is port


def test_every_kernel_the_cells_launch_is_named_by_the_port():
    """The kernels that the cells' steps launch are in the port's table."""
    names = tracing.port_kernel_names()
    assert {"tiled_fir_int8_kernel", "streamed_fir_int8_kernel"} <= names
    assert not any("at::" in n or "cutlass" in n for n in names)


def _command(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "stage.q7",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def _no_result(out: str) -> bool:
    lines = out.strip().splitlines()
    try:
        return not isinstance(json.loads(lines[-1]), dict)
    except (IndexError, json.JSONDecodeError):
        return True


def test_command_refuses_a_machine_without_the_card():
    """No card: a code other than 0, no result, no CPU fallback."""
    p = _command(manifest.ROOT)
    assert p.returncode != 0
    assert _no_result(p.stdout)
    assert "CUDA" in p.stderr


def test_command_fails_with_only_the_benchmark_files(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ alone."""
    import shutil
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path)
    assert p.returncode != 0
    assert _no_result(p.stdout)


def test_forbidden_modules_are_found(monkeypatch):
    from perfbench import run
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "speex_resampler_tpu.api",
                        types.ModuleType("y"))
    found = run.forbidden_modules()
    assert "jax" in found and "speex_resampler_tpu" in found
    assert "speex_resampler_tpu_torch" not in found


def test_nothing_loaded_is_jax():
    """Every benchmark module, its readers, entries and references, the
    port's kernel table and its step, in a fresh process: no top-level
    module of JAX or of the JAX package."""
    code = (
        "import sys, pkgutil, importlib, pathlib\n"
        "import perfbench\n"
        "from perfbench import tracing\n"
        "for m in pkgutil.walk_packages(perfbench.__path__, 'perfbench.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "from perfbench import manifest\n"
        "for p in (manifest.HERE / 'layer_metrics').glob('*.py'):\n"
        "    manifest.reader(p.stem)\n"
        "for p in (manifest.HERE / 'entries').glob('*.py'):\n"
        "    manifest.entry(p.stem)\n"
        "for w in manifest.load()['workloads']:\n"
        "    manifest.reference(manifest.cell(w['name']).config)\n"
        "print(sorted(tracing.port_kernel_names())[:1])\n"
        "import speex_resampler_tpu_torch.functional\n"
        "from perfbench.run import forbidden_modules\n"
        "print(forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stage.q7", "stage.q10"])
def test_command_on_the_card(name):
    """Each cell's command for 2 s on the card: correct, both metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert set(r["metrics"]) == {"out_rate", "setup_s"}
