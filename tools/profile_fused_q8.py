"""Profile the fused int8 dequant-into-aggregate of one or more checkouts on the card.

    python3 tools/profile_fused_q8.py SRC [SRC ...]

Each ``SRC`` is a checkout's ``src`` directory (this repository's ``src``, or
that of an older commit unpacked with ``git archive``).  The checkouts run in
turns, each in a process of its own (``A B B A`` for two), so drift on the
card hits both alike.  Each process builds its checkout's kernels, makes the
main path's inputs from a seed on the card — the (32, 10,174,464) int8 arena
at group 256 with its (32, 39,744) f32 scales — and, with all 32 rows live
and with 8 of 32 live (every fourth row, the FedBuff leg's count):

* holds ``masked_fedavg_q8_cuda`` against ``masked_fedavg_q8_torch`` (2e-5);
* times the wrapper call with CUDA events (median of 20 samples of 10 calls);
* traces 10 calls with ``torch.profiler``: the device kernels a call, their
  device time a call, and the longest kernel (the reduce's body) with its
  time a call and the DRAM rate it implies for the bytes the bound counts
  (each live row's values and scales read once, the output written once).

Prints the card's name and power limit, then one JSON line per process.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

P, N, GROUP = 10_174_464, 32, 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def _time_ms(fn, samples: int = 20, inner: int = 10) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def _trace(fn, calls: int = 10) -> dict:
    """Device kernels per call and their device time, from the fullest of up
    to three windows (the profiler has been seen to drop a record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best: dict[str, list[float]] = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
        if sum(map(len, seen.values())) > sum(map(len, best.values())):
            best = seen
        if sum(map(len, best.values())) >= calls:
            break
    body = max(best, key=lambda k: sum(best[k])) if best else None
    return {"kernels_per_call": sum(map(len, best.values())) / calls,
            "device_us_per_call": sum(map(sum, best.values())) / calls,
            "body": body, "body_us_per_call": sum(best[body]) / calls if body else None}


def profile_one(src: str) -> dict:
    import torch

    sys.path.insert(0, src)
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_agg as kfu

    dev = torch.device("cuda")
    built = _build.load_library()
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randint(-127, 128, (N, P), generator=gen, device=dev, dtype=torch.int8)
    s = torch.rand((N, P // GROUP), generator=gen, device=dev) * 5 + 0.01
    w = torch.rand((N,), generator=gen, device=dev) * 49 + 1
    out = {"src": src, "nvcc_s": built.seconds}
    for live in (32, 8):
        m = torch.zeros((N,), device=dev)
        m[:: N // live] = 1.0
        kern = lambda: kfu.masked_fedavg_q8_cuda(q, s, w, m)  # noqa: E731
        got, want = kern(), kfu.masked_fedavg_q8_torch(q, s, w, m)
        err = float((got.double() - want.double()).abs().max())
        ok = bool(((got.double() - want.double()).abs()
                   <= 2e-5 + 2e-5 * want.double().abs()).all())
        nbytes = live * P + 4 * live * (P // GROUP) + 4 * P + 8 * N
        tr = _trace(kern)
        out[f"live_{live}"] = {
            "max_abs_err": err, "within_2e-5": ok, "kernel_ms": _time_ms(kern),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, **tr,
            "body_dram_tb_s": nbytes / (tr["body_us_per_call"] * 1e-6) / 1e12
            if tr["body_us_per_call"] else None}
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(profile_one(argv[1])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not argv:
        sys.exit("profile_fused_q8: needs a CUDA card and at least one checkout's src")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    order = argv + argv[::-1] if len(argv) > 1 else argv
    rc = 0
    for src in order:
        proc = subprocess.run([sys.executable, __file__, "--one", str(pathlib.Path(src).resolve())],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            rc = proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
