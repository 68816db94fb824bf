"""Profile one hand-written kernel of one or more checkouts on the card, in turns.

    python3 tools/profile_kernel.py KERNEL [--rounds R] SRC [SRC ...]

``KERNEL`` is ``fused_q8`` (kernel 5, the fused int8 dequant-into-aggregate)
or ``dequantize`` (kernel 4, the int8 dequantize).  Each ``SRC`` is a
checkout's ``src`` directory (this repository's ``src``, or that of an older
commit unpacked with ``git archive``).  The checkouts run in turns, each in a
process of its own (``A B B A`` for two, repeated ``R`` times), so drift on
the card hits them alike.  Each process builds its checkout's kernels and
makes the main path's inputs from a seed on the card.

``fused_q8``: the (32, 10,174,464) int8 arena at group 256 with its
(32, 39,744) f32 scales, with all 32 rows live and with 8 of 32 live (every
fourth row, the FedBuff leg's count): ``masked_fedavg_q8_cuda`` against
``masked_fedavg_q8_torch`` (2e-5), the wrapper call, and the device kernels
``torch.profiler`` sees a call with the longest one (the reduce's body), its
time and the DRAM rate it implies for the bytes the bound counts.

``dequantize``, at the two shapes the main path gives ``dequantize_cuda``:

* the 10m row, ``(10,174,464,)`` int8 and ``(39,744,)`` scales at group 256
  (the int8-wire leg's decode), eight inputs quantized from normal rows and
  used in rotation (83 MB, so no call finds its input in the 50 MB L2): the
  wrapper call, the kernel's own time by CUDA events, the device kernels the
  profiler sees a call, the host microseconds a call (median of 5 runs of
  1,000 calls, and of 5 runs of 500 queued behind a sleep), ``torch.mul`` per group, the plain version, and the decode
  the controller runs (``ops.dequantize``, then the row's
  ``torch.linalg.vector_norm``): its time a call back to back, its device
  time and its host microseconds;
* the serve row, ``(3,879,927,808,)`` int8 and ``(15,155,968,)`` scales
  (gemma3-4b's pushed row, past 2^31): the wrapper call, the kernel's own
  time (3 each) and ``torch.mul``.

Every output is held bit for bit against ``dequantize_torch`` (at the serve
row on its first 2^20 values, the 2^21 around element 2^31 and the last
2^20).

Wrapper calls are CUDA-event medians of 20 samples of 10 calls, and device
times CUDA events behind a ``torch.cuda._sleep``, both as ``chip_smoke.py``
takes them (its helpers); bounds are the bytes the function must move over
3.35 TB/s.  Prints the card's name and power limit, one JSON line per
process, then one line per checkout with the median and range of each
number over its turns.  For ``dequantize`` and two checkouts or more, one
last process imports them side by side and times their wrappers' host
microseconds a call in turns within it (``dequantize_side_by_side``).
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
P, P_STACK, N, GROUP = 10_174_464, 10_174_081, 32, 256
P_SERVE = 3_879_927_808


def _trace(fn, calls: int = 10) -> dict:
    """Device kernels per call and their device time, from the fullest of up
    to three windows (the profiler has been seen to drop a record); ``body``
    is the kernel with the most device time."""
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


def _host_us_queued(fn, calls: int = 500) -> float:
    """Host microseconds a call, every call queued behind a ~50 ms
    ``torch.cuda._sleep`` so that no launch finds the stream idle (against
    ``chip_smoke._host_us``, where a kernel faster than its wrapper does)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def _same(a, b) -> bool:
    import torch

    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def profile_fused_q8(smoke) -> dict:
    import torch

    from repro_torch.kernels import fused_agg as kfu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randint(-127, 128, (N, P), generator=gen, device=dev, dtype=torch.int8)
    s = torch.rand((N, P // GROUP), generator=gen, device=dev) * 5 + 0.01
    w = torch.rand((N,), generator=gen, device=dev) * 49 + 1
    out = {}
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
            "max_abs_err": err, "within_2e-5": ok, "kernel_ms": smoke._time_ms(kern),
            "bound_ms": nbytes / smoke.HBM_BYTES_PER_S * 1e3, **tr,
            "body_dram_tb_s": nbytes / (tr["body_us_per_call"] * 1e-6) / 1e12
            if tr["body_us_per_call"] else None}
    return out


def profile_dequantize(smoke) -> dict:
    import itertools

    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as kq

    dev = torch.device("cuda")
    wrapper = kq.dequantize_cuda
    out = {"bit_identical": True}
    gen = torch.Generator(device=dev).manual_seed(3)
    groups = P // GROUP
    qs = [kq.quantize_cuda(torch.randn((P_STACK,), generator=gen, device=dev) * 3, GROUP, P)
          for _ in range(8)]
    for q, s in qs:
        out["bit_identical"] &= _same(wrapper(q, s, GROUP), kq.dequantize_torch(q, s, GROUP))
    turn = itertools.cycle(qs)
    kern = lambda: wrapper(*next(turn), GROUP)  # noqa: E731
    decode_norm = lambda: torch.linalg.vector_norm(  # noqa: E731
        ops.dequantize(*next(turn), P_STACK))

    def library():
        q, s = next(turn)
        return torch.mul(q.view(groups, GROUP), s[:, None])

    out["row_10m"] = {
        "shape": [P], "bound_ms": (P + 4 * groups + 4 * P) / smoke.HBM_BYTES_PER_S * 1e3,
        "kernel_ms": smoke._time_ms(kern),
        "device_ms": statistics.median(smoke._device_body_ms("dequantize", wrapper, kern, 5)),
        **_trace(kern),
        "host_us": statistics.median(smoke._host_us(kern) for _ in range(5)),
        "host_us_queued": statistics.median(_host_us_queued(kern) for _ in range(5)),
        "plain_ms": smoke._time_ms(lambda: kq.dequantize_torch(*next(turn), GROUP)),
        "library_ms": smoke._time_ms(library),
        "decode_norm_ms": smoke._time_ms(decode_norm),
        "decode_norm_device_ms": statistics.median(
            smoke._device_body_ms("decode + norm", wrapper, decode_norm, 5)),
        "decode_norm_host_us": statistics.median(smoke._host_us(decode_norm)
                                                 for _ in range(5))}
    del qs, turn, kern, decode_norm, library
    torch.cuda.empty_cache()

    groups = P_SERVE // GROUP
    q = torch.randint(-127, 128, (P_SERVE,), generator=gen, device=dev, dtype=torch.int8)
    s = torch.rand((groups,), generator=gen, device=dev) * 5 + 1e-3
    got = wrapper(q, s, GROUP)
    tail = P_SERVE - 2 ** 20
    for a, b in ((0, 2 ** 20), (2 ** 31 - 2 ** 20, 2 ** 31 + 2 ** 20), (tail, P_SERVE)):
        out["bit_identical"] &= _same(got[a:b], kq.dequantize_torch(
            q[a:b], s[a // GROUP:b // GROUP], GROUP))
    del got
    kern = lambda: wrapper(q, s, GROUP)  # noqa: E731
    out["row_serve"] = {
        "shape": [P_SERVE],
        "bound_ms": (P_SERVE + 4 * groups + 4 * P_SERVE) / smoke.HBM_BYTES_PER_S * 1e3,
        "kernel_ms": smoke._time_ms(kern, 3, 1),
        "device_ms": statistics.median(smoke._device_body_ms("dequantize", wrapper, kern, 3)),
        "library_ms": smoke._time_ms(
            lambda: torch.mul(q.view(groups, GROUP), s[:, None]), 3, 1)}
    return out


KERNELS = {"fused_q8": profile_fused_q8, "dequantize": profile_dequantize}


def profile_one(kernel: str, src: str) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as smoke

    from repro_torch.kernels import _build

    built = _build.load_library()
    out = {"kernel": kernel, "src": src, "nvcc_s": built.seconds, **KERNELS[kernel](smoke)}
    out["failures"] = smoke.FAILURES
    return out


def dequantize_side_by_side(srcs: list[str], rounds: int = 40, calls: int = 200) -> dict:
    """Host microseconds a call of each checkout's ``dequantize_cuda``, and of
    the controller's decode (``ops.dequantize`` and the norm), with every
    checkout imported side by side in this one process (each module keeps
    its own globals and its own library) and run in turns, ``A B B A``
    ``rounds`` times, ``calls`` calls a turn: the host's drift between
    processes, ten times the difference sought, cancels.  ``queued``: each
    turn behind a ~50 ms sleep, so that no launch finds the stream idle."""
    import itertools

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    mods = []
    for src in srcs:
        for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]
        sys.path.insert(0, src)
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels import quantize as kq

        _build.load_library()
        mods.append((kq, ops))
        sys.path.remove(src)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    qs = [mods[0][0].quantize_cuda(torch.randn((P_STACK,), generator=gen, device=dev) * 3,
                                   GROUP, P) for _ in range(8)]
    turn = itertools.cycle(qs)
    fns = {}
    for src, (kq, ops) in zip(srcs, mods):
        fns[src] = {
            "host_us": lambda kq=kq: kq.dequantize_cuda(*next(turn), GROUP),
            "decode_norm_host_us": lambda ops=ops: torch.linalg.vector_norm(
                ops.dequantize(*next(turn), P_STACK))}
    got: dict[str, dict[str, list[float]]] = {s: {} for s in srcs}
    for _ in range(rounds):
        for src in srcs + srcs[::-1]:
            for key, fn in fns[src].items():
                got[src].setdefault(key, []).append(smoke._host_us(fn, calls))
                got[src].setdefault(f"{key}_queued", []).append(_host_us_queued(fn, calls))
    first = srcs[0]
    return {src: {key: {"median": statistics.median(v), "min": min(v), "max": max(v),
                        "paired_minus_first_median": statistics.median(
                            b - a for a, b in zip(got[first][key], v))}
                  for key, v in keys.items()}
            for src, keys in got.items()}


SIDE_BY_SIDE = {"dequantize": dequantize_side_by_side}


def _summary(runs: list[dict]) -> dict:
    """The median, least and most of each number over the runs, by key path."""
    def numbers(d: dict, at: str = ""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from numbers(v, f"{at}{k}.")
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                yield f"{at}{k}", v

    seen: dict[str, list[float]] = {}
    for run in runs:
        for k, v in numbers(run):
            seen.setdefault(k, []).append(v)
    return {k: {"median": statistics.median(v), "min": min(v), "max": max(v), "n": len(v)}
            for k, v in seen.items()}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(profile_one(argv[1], argv[2])), flush=True)
        return 0
    if argv[:1] == ["--side-by-side"]:
        print(json.dumps({"side_by_side": SIDE_BY_SIDE[argv[1]](argv[2:])}), flush=True)
        return 0
    import torch

    rounds = 1
    if argv[1:2] == ["--rounds"]:
        rounds, argv = int(argv[2]), argv[:1] + argv[3:]
    if not torch.cuda.is_available() or len(argv) < 2 or argv[0] not in KERNELS:
        sys.exit(f"profile_kernel: needs a CUDA card, a kernel of {sorted(KERNELS)} "
                 "and at least one checkout's src")
    kernel, srcs = argv[0], [str(pathlib.Path(s).resolve()) for s in argv[1:]]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    order = (srcs + srcs[::-1] if len(srcs) > 1 else srcs) * rounds
    rc, runs = 0, {s: [] for s in srcs}
    for src in order:
        proc = subprocess.run([sys.executable, __file__, "--one", kernel, src],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            rc = proc.returncode
            continue
        run = json.loads(proc.stdout.splitlines()[-1])
        runs[src].append(run)
        rc = rc or int(bool(run["failures"]) or not run.get("bit_identical", True))
    for src, got in runs.items():
        print(json.dumps({"src": src, "turns": len(got), "summary": _summary(got)}), flush=True)
    if kernel in SIDE_BY_SIDE and len(srcs) > 1:
        proc = subprocess.run([sys.executable, __file__, "--side-by-side", kernel, *srcs],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
