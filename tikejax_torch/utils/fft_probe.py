"""Where the time goes inside the FFT kernels and ``scatter_conj_probe``'s
tile kernel, on the card.

    python -m tikejax_torch.utils.fft_probe            # the FFT kernels
    python -m tikejax_torch.utils.fft_probe scatter    # the tile scatter

needs one CUDA card and ``nvcc``. At the headline frame size (16,384
positions, 128^2 probe and detector, one mode) it times ``grad_fused``,
``minf_fused``, ``grad_prb_fused`` and ``adj_probe`` on their ``'fft'``
variant -- as launched, without the data prefetch, at 512 threads;
``grad_fused`` on its shared-memory body, forced, with its fused body as
launched beside it -- and on the forced ``'gemm'`` variant; then
``grad_fused`` (the shared-memory body) and ``adj_probe`` built
from patched copies of ``csrc/`` that each leave one phase of the kernel out
(the transforms, the store of the cropped frames the tile scatter sums, the
data read, the gather's loads; the farplane load, the partial's update),
which says what that phase costs (``grad_fused`` as launched: its frame
kernel and the tile scatter).

``scatter`` times ``scatter_conj_probe``'s tile kernel at one mode and at
4 modes against the forced atomic kernel; then the tile kernel on inputs
that take one cost away (every position reading one frame, which stays in
L2; every position masked with every chunk walked, which leaves the walk
over the scan alone; window corners on multiples of 4 columns, so that no
frame-row segment straddles a 32-byte sector more than it must) and with
every chunk walked (no chunk skip); then built from patched copies that
leave the frame loads, the probe loads or both out, or keep another number
of loads in flight or of blocks resident.

The patched kernels compute nothing meaningful and are only timed; the
copies go under the build directory. Medians of 7 launches with CUDA
events.
"""

from __future__ import annotations

import contextlib
import shutil
import statistics
import sys

import torch

from tikejax_torch import Geometry
from tikejax_torch.models import make_problem
from tikejax_torch.ops import fused, kernels
from tikejax_torch.ops.patches import scan_to_int
from tikejax_torch.utils import cuda_build

HEADLINE = dict(nz=512, n=512, nscan=16384, ndet=128, nprb=128)
# {probe: (kernel timed, [(file, text to find exactly once, replacement)])}
PATCHES = {
    "no transforms": ("grad_fused", [(
        "dft_frame.cuh", "  auto row_at = [](int r, int e) {",
        "  __syncthreads();\n  return;\n  auto row_at = [](int r, int e) {")]),
    "no crop store": ("grad_fused", [(
        "dft_frame.cuh", "    nr[i] = fr[fft_near_index<kD>(y, x)];",
        "    if (p < 0) nr[i] = fr[fft_near_index<kD>(y, x)];")]),
    "no data read": ("grad_fused", [(
        "dft_frame.cuh", "staged != nullptr ? staged[i] : __ldcs(dat + i),",
        "1.0f,")]),
    "no gather loads": ("grad_fused", [(
        "dft_frame.cuh",
        "        cmul(obj[static_cast<int64_t>(y) * n + x], pr[i]);",
        "        make_float2(1.f, 0.f);")]),
    "no farplane load": ("adj_probe", [(
        "adj_probe.cu", "const float4 w = __ldcs(src + i);",
        "const float4 w = make_float4(1.f, 0.f, 1.f, 0.f);")]),
    "no partial update": ("adj_probe", [(
        "adj_probe.cu",
        "        float2& a = out[i];\n"
        "        a = make_float2(a.x + g.x, a.y + g.y);",
        "        float2& a = out[i];\n"
        "        if (g.x == 12345.f) a = make_float2(a.x + g.x, a.y + g.y);")]),
}
_SCATTER = "scatter_conj_probe.cu"
_FRAME_LOAD = (_SCATTER, "@p ld.global.cs.v2.f32 {%0, %1}, [%2];",
               "mov.f32 %0, 0f3F800000;")
_PROBE_LOAD = (_SCATTER, "@p ld.global.nc.v2.f32 {%0, %1}, [%2];",
               "mov.f32 %0, 0f3F800000;")


def _loads(k: int):
    return (_SCATTER, "constexpr int kLoads = 12;",
            f"constexpr int kLoads = {k};")


PATCHES.update({
    "no frame loads": ("scatter_conj_probe", [_FRAME_LOAD]),
    "no probe loads": ("scatter_conj_probe", [_PROBE_LOAD]),
    "no loads": ("scatter_conj_probe", [_FRAME_LOAD, _PROBE_LOAD]),
    "8 loads in flight": ("scatter_conj_probe", [_loads(8)]),
    "16 loads in flight": ("scatter_conj_probe", [_loads(16)]),
    "8 loads in flight, 3 blocks an SM": ("scatter_conj_probe", [
        _loads(8), (_SCATTER, "__launch_bounds__(kThreads, 2)",
                    "__launch_bounds__(kThreads, 3)")]),
})


def median_ms(fn, reps: int = 7) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _forget_loaded_libraries() -> None:
    fused._lib.cache_clear()
    kernels._lib.cache_clear()
    fused.fft_launch_config.cache_clear()
    cuda_build._LOADED.clear()


@contextlib.contextmanager
def patched_sources(label: str, edits):
    """Build from a copy of ``csrc/`` with ``edits`` applied; the real
    sources are back in place afterwards."""
    real = cuda_build.CSRC
    copy = cuda_build.BUILD_DIR.parent / "probe" / label.replace(" ", "_")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(real, copy)
    for name, old, new in edits:
        text = (copy / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"probe {label!r}: {name} no longer holds "
                               f"exactly one {old!r}")
        (copy / name).write_text(text.replace(old, new))
    cuda_build.CSRC = copy
    _forget_loaded_libraries()
    try:
        yield
    finally:
        cuda_build.CSRC = real
        _forget_loaded_libraries()


def fft_kernels(dev) -> None:
    g = Geometry(**HEADLINE)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, scan, prb, data = make_problem(gen, g, device=dev)
    scan_i = scan_to_int(scan)

    def crandn(shape):
        return torch.complex(torch.randn(shape, generator=gen, device=dev),
                             torch.randn(shape, generator=gen, device=dev))

    psi, far = crandn(g.psi_shape), crandn(g.farplane_shape)
    args = (psi, data, scan_i, prb, g.ndet, "gaussian")
    runs = {
        # The shared-memory body, which the patches below take apart.
        "grad_fused": lambda **kw: fused._grad_fused_cuda(
            *args, None, **{"variant": "fft_smem", **kw}),
        "minf_fused": lambda **kw: fused._minf_fused_cuda(*args, None, **kw),
        "grad_prb_fused": lambda **kw: fused._grad_prb_fused_cuda(*args,
                                                                  **kw),
        "adj_probe": lambda **kw: fused._adj_probe_cuda(far, scan_i, psi,
                                                        g.nprb, **kw),
    }
    print(f"{torch.cuda.get_device_name(0)}; {g}", flush=True)
    whole = {}
    for name, run in runs.items():
        run()  # build and warm up
        whole[name] = median_ms(run)
        line = [f"fft {whole[name]:.3f} ms"]
        if name != "adj_probe":
            off = median_ms(lambda: run(prefetch=False))
            line.append(f"prefetch off {off:.3f}")
            whole[name, "prefetch off"] = off
        line.append(f"512 threads {median_ms(lambda: run(threads=512)):.3f}")
        line.append(f"gemm {median_ms(lambda: run(variant='gemm')):.3f}")
        if name == "grad_fused":
            line.append("fused body (as launched) "
                        f"{median_ms(lambda: run(variant=None)):.3f}")
        print(f"{name}: " + ", ".join(line), flush=True)
    for label, (name, edits) in PATCHES.items():
        if name not in runs:
            continue
        with patched_sources(label, edits):
            run = runs[name]
            run()
            kw = {} if name == "adj_probe" else {"prefetch": False}
            ms = median_ms(lambda: run(**kw))
        base = whole[name] if name == "adj_probe" else whole[name,
                                                            "prefetch off"]
        print(f"{name}, {label}: {ms:.3f} ms of {base:.3f} "
              f"({base - ms:+.3f})", flush=True)


def scatter_kernel(dev) -> None:
    g = Geometry(**HEADLINE)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, scan, prb, _ = make_problem(gen, g, device=dev)
    scan_i = scan_to_int(scan)

    def crandn(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device=dev),
                             torch.randn(shape, generator=gen, device=dev))

    near = crandn(1, g.nscan, 1, g.nprb, g.nprb)
    near4, prb4 = crandn(1, g.nscan, 4, g.nprb, g.nprb), crandn(1, 4, g.nprb,
                                                                g.nprb)
    one = near[:, :1].expand(near.shape)  # one frame for every position
    masked = scan_i.clone()
    masked[..., 0] = -1
    aligned = scan_i.clone()
    aligned[..., 1] = aligned[..., 1] // 4 * 4

    def tile(frames=near, scan=scan_i, probe=prb, **kw):
        return lambda: kernels._scatter_conj_probe_cuda(
            frames, scan, probe, g.nz, g.n, **kw)

    runs = {"one mode": tile(), "4 modes": tile(near4, probe=prb4)}
    print(f"{torch.cuda.get_device_name(0)}; {g}; tile "
          f"{kernels.SCATTER_TILE}", flush=True)
    base = {}
    for label, run in runs.items():
        run()  # build and warm up
        base[label] = median_ms(run)
        frames, probe = (near, prb) if label == "one mode" else (near4, prb4)
        atomic = median_ms(tile(frames, probe=probe, variant="atomic"))
        print(f"{label}: tile {base[label]:.3f} ms, atomic {atomic:.3f}",
              flush=True)
    for label, run in (("one frame for every position", tile(one)),
                       ("every position masked, every chunk walked",
                        tile(scan=masked, skip=False)),
                       ("corners on multiples of 4 columns",
                        tile(scan=aligned)),
                       ("every chunk walked", tile(skip=False))):
        run()
        print(f"one mode, {label}: {median_ms(run):.3f} ms of "
              f"{base['one mode']:.3f}", flush=True)
    for label, (name, edits) in PATCHES.items():
        if name != "scatter_conj_probe":
            continue
        with patched_sources(label, edits):
            line = []
            for case, run in runs.items():
                run()
                line.append(f"{case} {median_ms(run):.3f} ms of "
                            f"{base[case]:.3f}")
        print(f"{label}: " + ", ".join(line), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fft_probe needs a CUDA card")
    which = sys.argv[1:] or ["fft"]
    if which not in (["fft"], ["scatter"]):
        raise SystemExit("usage: python -m tikejax_torch.utils.fft_probe "
                         "[fft|scatter]")
    dev = torch.device("cuda", 0)
    (fft_kernels if which == ["fft"] else scatter_kernel)(dev)


if __name__ == "__main__":
    main()
