#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each of which raises on a failed check:

1. card: the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a and print what
   ptxas reports (registers, shared memory, spills);
2. kernels: each kernel against its plain PyTorch version on the card,
   t in {8, 16, 32, 64}, bt in {0, 1, 3}, nat in {0, 1, 3}, start_tile in
   {0, 2}, nchunks in {1, 3}, plus a breakdown input whose status word
   must match exactly;
3. main path at full size: Table II matrices 5 (n=10,200, bandwidth 200,
   arrow 200) and 2 (n=10,010, bandwidth 200, arrow 10), seed 0, t=64:
   measure_arrowhead -> TileGrid -> BandedCTSF.from_sparse ->
   factorize_window -> logdet, with launch counts, the factor residual and
   logdet against a float64 oracle on the card;
4. timings at the main path's shapes: each kernel, its plain version and
   a one-call PyTorch yardstick where there is one (device time from
   torch.profiler, call time from CUDA events), beside the kernel's bound;
   where the sweep's cycles go, from a phase-marked build of its kernel;
   factorize_window end to end.

The second-to-last lines are the kernel JSON line and the card line; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero with no
result where there is no CUDA device or no checkout around the script.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet): fp32 without tensor cores,
# and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TOL = 2e-4          # rtol = atol, the tolerance of the repo's kernel tests
TILES = (8, 16, 32, 64)
TABLE2_IDS = (5, 2)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def random_band_arrow(torch, ndt, bt, nat, t, seed, device, bad_tile=None):
    """Column-band tiles Ac (ndt, bt+1, t, t) and arrow rows R (ndt, nat, t,
    t) of a random diagonally dominant (so SPD) banded-arrowhead matrix;
    with ``bad_tile`` one diagonal entry of that band tile is negative."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = (ndt + nat) * t
    tile = np.arange(n) // t
    ti, tj = tile[:, None], tile[None, :]
    mask = ((ti < ndt) & (tj < ndt) & (np.abs(ti - tj) <= bt)) | (ti >= ndt) | (tj >= ndt)
    a = np.where(mask, rng.standard_normal((n, n)), 0.0)
    a = np.tril(a) + np.tril(a, -1).T
    a[np.diag_indices(n)] = np.abs(a).sum(axis=1) + 1.0
    if bad_tile is not None:
        i = bad_tile * t + t // 2
        a[i, i] = -a[i, i]
    Ac = np.zeros((ndt, bt + 1, t, t), np.float32)
    R = np.zeros((ndt, nat, t, t), np.float32)
    for k in range(ndt):
        for e in range(bt + 1):
            if k + e < ndt:
                Ac[k, e] = a[(k + e) * t:(k + e + 1) * t, k * t:(k + 1) * t]
        for i in range(nat):
            R[k, i] = a[(ndt + i) * t:(ndt + i + 1) * t, k * t:(k + 1) * t]
    return (torch.from_numpy(Ac).to(device), torch.from_numpy(R).to(device))


def random_spd(torch, nb, t, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((nb, t, t), generator=g, dtype=torch.float64)
    return (x @ x.mT + t * torch.eye(t, dtype=torch.float64)).float().to(device)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def assert_close(torch, got, want, what, tol=TOL):
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.allclose(got, want, rtol=tol, atol=tol, equal_nan=True):
        err = (got - want).abs().nan_to_num(float("inf")).max().item()
        raise AssertionError(f"{what}: max abs err {err:.3e} over rtol=atol={tol}")
    diff = (got - want).abs()
    return diff[torch.isfinite(diff)].max().item() if diff.numel() else 0.0


def check_status(got, want, what):
    g, w = got.tolist(), want.tolist()
    if g[1] != w[1] or g[2] != w[2]:
        raise AssertionError(f"{what}: status {g} != plain {w} (nonfinite, first_bad)")
    if not (g[0] == w[0] or abs(g[0] - w[0]) <= TOL * abs(w[0]) + 1e-6):
        raise AssertionError(f"{what}: min_pivot {g[0]} != plain {w[0]}")


def phase_kernels(torch, device, kern, ref):
    """Every kernel in ``kern`` (name -> wrapper) against its plain version."""
    nchecks = 0
    for t in TILES:
        a = random_spd(torch, 3, t, t, device)
        assert_close(torch, kern["potrf"](a), ref.potrf_ref(a), f"potrf t={t}")
        l = ref.potrf_ref(a)
        b = torch.randn((3, t, t), generator=torch.Generator().manual_seed(t)).to(device)
        assert_close(torch, kern["trsm"](l[0], b), ref.trsm_ref(l[0], b), f"trsm t={t}")
        assert_close(torch, kern["trsm"](l, b), ref.trsm_ref(l, b), f"trsm batched-L t={t}")
        nchecks += 3
        for bt in (0, 1, 3):
            for nat in (0, 1, 3):
                ndt = 5
                Ac, R = random_band_arrow(torch, ndt, bt, nat, t, seed=100 * t + 10 * bt + nat,
                                          device=device)
                for start in (0, 2):
                    for nch in (1, 3):
                        what = f"sweep t={t} bt={bt} nat={nat} start={start} nchunks={nch}"
                        got = kern["band_cholesky_sweep"](Ac, R, nchunks=nch, start_tile=start)
                        want = ref.band_cholesky_sweep_ref(Ac, R, nchunks=nch, start_tile=start)
                        for g, w, part in zip(got[:3], want[:3], ("panels", "R_out", "schur")):
                            assert_close(torch, g, w, f"{what} {part}")
                        check_status(got[3], want[3], what)
                        nchecks += 1
        # breakdown: a negative diagonal entry in band tile 2
        Ac, R = random_band_arrow(torch, 5, 1, 1, t, seed=7, device=device, bad_tile=2)
        got = kern["band_cholesky_sweep"](Ac, R, nchunks=3)
        want = ref.band_cholesky_sweep_ref(Ac, R, nchunks=3)
        check_status(got[3], want[3], f"breakdown t={t}")
        if want[3][2].item() != 2.0 or want[3][1].item() != 1.0:
            raise AssertionError(f"breakdown t={t}: plain status {want[3].tolist()} does "
                                 "not flag tile 2")
        assert_close(torch, got[0][:2], want[0][:2], f"breakdown t={t} clean panels")
        nchecks += 1
    return nchecks


# ---------------------------------------------------------------------------
# phase 3: the main path at full size
# ---------------------------------------------------------------------------

def dense_from_ctsf(torch, m, dtype, symmetric):
    """The padded dense matrix of a BandedCTSF, assembled on its device."""
    g = m.grid
    t, ndt, nat, bt = g.t, g.n_diag_tiles, g.n_arrow_tiles, g.band_tiles
    out = torch.zeros((g.padded_n, g.padded_n), dtype=dtype, device=m.device)
    for d in range(bt + 1):
        for k in range(d, ndt):
            out[k * t:(k + 1) * t, (k - d) * t:(k - d + 1) * t] = m.Dr[k, d]
    off = ndt * t
    for i in range(nat):
        out[off + i * t:off + (i + 1) * t, :off] = m.R[:, i].permute(1, 0, 2).reshape(t, off)
        for j in range(i + 1):
            out[off + i * t:off + (i + 1) * t, off + j * t:off + (j + 1) * t] = m.C[i, j]
    if symmetric:
        out = torch.tril(out) + torch.tril(out, -1).mT
    return out


def needed_flops(grid):
    """Operations the factorization of ``grid`` needs, split into the band
    sweep's share and the dense corner's: the symbolic task list of its
    dense-band pattern (``core.symbolic``), a POTRF t^3/3, a SYRK t^3 (its
    product is symmetric, so one triangle is needed), a TRSM t^3 and a GEMM
    2 t^3.  The sweep owns every task on a band column and every
    corner-Schur update from one; the rest is the corner's."""
    from repro_torch.core import (TaskType, banded_arrowhead_tile_pattern,
                                  symbolic_factorize)
    t, ndt = grid.t, grid.n_diag_tiles
    cost = {TaskType.POTRF: t ** 3 / 3.0, TaskType.SYRK: float(t) ** 3,
            TaskType.TRSM: float(t) ** 3, TaskType.GEMM: 2.0 * t ** 3}
    sweep = corner = 0.0
    for task in symbolic_factorize(banded_arrowhead_tile_pattern(grid)).tasks:
        if task.k < ndt or 0 <= task.n < ndt:
            sweep += cost[task.type]
        else:
            corner += cost[task.type]
    return sweep, corner


def run_matrix(torch, matrix_id, device=None, scale=1.0, kern_counts=None):
    """One Table II matrix through the main path (on the card unless
    ``device`` says otherwise); returns its record."""
    from repro_torch.core import (BandedCTSF, TileGrid, factorize_window, logdet,
                                  measure_arrowhead)
    from repro_torch.data import table2_matrix

    t0 = time.perf_counter()
    A, st = table2_matrix(matrix_id, scale=scale, seed=0)
    measured = measure_arrowhead(A, arrow_hint=st.arrow)
    grid = TileGrid(measured, t=64 if scale == 1.0 else 16)
    m = BandedCTSF.from_sparse(A, grid, device=device)
    host_s = time.perf_counter() - t0
    ndt, bt, nat, t = grid.n_diag_tiles, grid.band_tiles, grid.n_arrow_tiles, grid.t

    before = kern_counts() if kern_counts else None
    f = factorize_window(m)
    ld = logdet(f)
    if m.device.type == "cuda":
        torch.cuda.synchronize()
    launches = None
    if kern_counts:
        after = kern_counts()
        launches = {k: after[k] - before[k] for k in after}
        want = {"band_cholesky_sweep": 1, "potrf": nat, "trsm": nat}
        if launches != want:
            raise AssertionError(f"matrix {matrix_id}: launches {launches} != {want}")

    # the factor: max|L L^T - A| / max|A| and logdet against a float64 oracle
    Ad = dense_from_ctsf(torch, m, torch.float64, symmetric=True)
    Ld = dense_from_ctsf(torch, f.ctsf, torch.float64, symmetric=False)
    resid = ((Ld @ Ld.mT - Ad).abs().max() / Ad.abs().max()).item()
    oracle = (2.0 * torch.log(torch.diagonal(torch.linalg.cholesky(Ad)))).sum().item()
    ld = ld.item()
    ld_rel = abs(ld - oracle) / abs(oracle)
    del Ad, Ld
    finite = all(torch.isfinite(x).all().item() for x in f.ctsf.arrays())
    status = f.status.tolist()
    if not finite or status[1:] != [0.0, -1.0] or resid > 1e-4 or ld_rel > 1e-4:
        raise AssertionError(f"matrix {matrix_id}: finite={finite} status={status} "
                             f"residual={resid:.3e} logdet={ld} oracle={oracle} "
                             f"rel={ld_rel:.3e}")
    rec = dict(matrix=matrix_id, n=measured.n, bandwidth=measured.bandwidth,
               arrow=measured.arrow, t=t, ndt=ndt, bt=bt, nat=nat,
               host_setup_s=round(host_s, 3), residual=resid, logdet=ld,
               logdet_oracle=oracle, logdet_rel_err=ld_rel, status=status,
               launches=launches)
    return rec, m, f


# ---------------------------------------------------------------------------
# phase 4: timings
# ---------------------------------------------------------------------------

def time_ms(torch, fn, inner=1, reps=7, warmup=2):
    """Median over ``reps`` of CUDA-event time per call, ``inner`` calls a rep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return statistics.median(times)


def device_ms(torch, fn, calls=10):
    """Device time per call: the CUDA kernels' time summed over ``calls``
    calls by torch.profiler, and the kernels by name; (None, {}) if the
    profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3 / calls
    total = sum(by_name.values())
    return (total if total > 0 else None), by_name


def bound(flops, nbytes):
    tf, tb = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: no src/repro_torch beside this script; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on an H100", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.band_cholesky import band_cholesky_sweep_cuda
    from repro_torch.kernels.potrf import potrf_cuda
    from repro_torch.kernels.trsm import trsm_cuda
    from repro_torch.kernels.ring import band_row_to_col, chunk_layout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda:0"
    kern = {"potrf": potrf_cuda, "trsm": trsm_cuda, "band_cholesky_sweep": band_cholesky_sweep_cuda}

    def counts():
        return {k: f.launches for k, f in kern.items()}

    # 1. card and build
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(_build.SOURCES)}")
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    n = phase_kernels(torch, dev, kern, ref)
    torch.cuda.synchronize()
    log(f"kernels: {n} comparisons with the plain versions pass "
        f"(rtol=atol={TOL}) in {time.perf_counter() - t0:.1f} s")

    # 3. main path at full size; counts reset just before, read just after
    for k in kern.values():
        k.launches = 0
    records, mats = [], {}
    for mid in TABLE2_IDS:
        rec, m, f = run_matrix(torch, mid, kern_counts=counts)
        records.append(rec)
        mats[mid] = (m, f)
        log(f"main path: Table II matrix {mid}: " + json.dumps(rec))
    main_launches = counts()

    # 4. timings at the main path's shapes (matrix 5), kernel vs plain
    m, f = mats[TABLE2_IDS[0]]
    g = m.grid
    ndt, bt, nat, t = g.n_diag_tiles, g.band_tiles, g.n_arrow_tiles, g.t
    sweep_ops, _ = needed_flops(g)
    nchunks = max(1, min(8, ndt))
    Ac = band_row_to_col(m.Dr)
    sweep_k = lambda: band_cholesky_sweep_cuda(Ac, m.R, nchunks=nchunks)
    sweep_p = lambda: ref.band_cholesky_sweep_ref(Ac, m.R, nchunks=nchunks)
    got, want = sweep_k(), sweep_p()
    sweep_err = max(assert_close(torch, a, b, f"main-path sweep {p}")
                    for a, b, p in zip(got[:3], want[:3], ("panels", "R_out", "schur")))
    check_status(got[3], want[3], "main-path sweep")
    # the corner's first column: its potrf and trsm inputs
    corner = m.C - got[2].sum(dim=0)
    a_kk = corner[0, 0].contiguous()
    l_kk = ref.potrf_ref(a_kk)
    col = corner[:, 0].contiguous()
    potrf_err = assert_close(torch, potrf_cuda(a_kk), l_kk, "main-path potrf")
    trsm_err = assert_close(torch, trsm_cuda(l_kk, col), ref.trsm_ref(l_kk, col),
                            "main-path trsm")

    csz, nch = chunk_layout(ndt, nchunks)
    sweep_bytes = 4 * t * t * (2 * ndt * (bt + 1) + 2 * ndt * nat + nch * nat * nat) + 12
    kernels = []
    for name, src, replaces, fk, fp, flib, inner, flops, nbytes, err in (
            ("potrf", "src/repro_torch/kernels/csrc/potrf.cu", "src/repro/kernels/potrf.py:70",
             lambda: potrf_cuda(a_kk), lambda: ref.potrf_ref(a_kk),
             lambda: torch.linalg.cholesky(a_kk), 20, t ** 3 / 3.0, 2 * 4 * t * t,
             potrf_err),
            ("trsm", "src/repro_torch/kernels/csrc/trsm.cu", "src/repro/kernels/trsm.py:82",
             lambda: trsm_cuda(l_kk, col), lambda: ref.trsm_ref(l_kk, col),
             lambda: torch.linalg.solve_triangular(l_kk, col.mT, upper=False),
             20, nat * float(t) ** 3, 4 * t * t * (1 + 2 * nat), trsm_err),
            ("band_cholesky_sweep", "src/repro_torch/kernels/csrc/band_cholesky.cu",
             "src/repro/kernels/band_cholesky.py:168", sweep_k, sweep_p, None, 1,
             sweep_ops, sweep_bytes, sweep_err)):
        # call time: CUDA events around `inner` calls, host overhead included;
        # device time: the kernels alone, from the profiler
        call = dict(kernel=time_ms(torch, fk, inner=inner),
                    plain=time_ms(torch, fp, inner=1 if name == "band_cholesky_sweep" else inner,
                                  reps=5, warmup=1),
                    library=time_ms(torch, flib, inner=inner) if flib else None)
        on_device = {}
        for what, fn in (("kernel", fk), ("plain", fp), ("library", flib)):
            if fn is not None:
                on_device[what], names = device_ms(torch, fn, calls=3 if name == "band_cholesky_sweep" else 10)
                log(f"  {name} {what} device kernels: " + ", ".join(
                    f"{k[:60]} {v:.4f} ms" for k, v in sorted(names.items(), key=lambda kv: -kv[1])[:4]))
        timing = "device" if all(on_device.get(w) for w in on_device) else "events"
        pick = on_device if timing == "device" else call
        b_ms, b_by = bound(flops, nbytes)
        # launches: the main path's total over every matrix it ran, and per
        # factorize_window of each; the times are at matrix TABLE2_IDS[0]'s shapes
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=main_launches[name],
                            launches_per_factorize_window={
                                str(r["matrix"]): r["launches"][name] for r in records},
                            max_abs_err=err,
                            ms=pick["kernel"], plain_ms=pick["plain"], bound_ms=b_ms,
                            bound_by=b_by, library_ms=pick.get("library"), timing=timing,
                            call_ms=call["kernel"], plain_call_ms=call["plain"],
                            library_call_ms=call["library"],
                            timed_shape=dict(matrix=TABLE2_IDS[0], ndt=ndt, bt=bt,
                                             nat=nat, t=t)))
        fmt = lambda v: "-" if v is None else f"{v:.4f}"
        log(f"time {name}: device {fmt(on_device.get('kernel'))} ms, call {fmt(call['kernel'])} ms; "
            f"plain device {fmt(on_device.get('plain'))} ms, call {fmt(call['plain'])} ms; library "
            f"device {fmt(on_device.get('library'))} ms, call {fmt(call['library'])} ms; bound "
            f"{b_ms:.5f} ms by {b_by}")

    # where the sweep's time goes, from the phase-marked build of the kernel
    from repro_torch.kernels.band_cholesky import sweep_phase_cycles
    for rec in records:
        mm, _ = mats[rec["matrix"]]
        cyc = sweep_phase_cycles(band_row_to_col(mm.Dr), mm.R, nchunks=nchunks)
        total = sum(cyc.values())
        rec["sweep_phase_cycles"] = cyc
        log(f"sweep phases: Table II matrix {rec['matrix']}: {total / 1e6:.2f} M cycles: " +
            ", ".join(f"{k} {v / 1e6:.2f} M ({100 * v / total:.0f}%)" for k, v in cyc.items()))
    kernels[-1]["phase_cycles"] = records[0]["sweep_phase_cycles"]

    # factorize_window end to end, and its peak memory, per matrix
    from repro_torch.core import factorize_window, logdet
    for rec in records:
        mm, _ = mats[rec["matrix"]]
        gg = mm.grid
        fw = lambda: logdet(factorize_window(mm))
        ms = time_ms(torch, fw, reps=7, warmup=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fw()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        fl = sum(needed_flops(gg))
        log(f"factorize_window+logdet: Table II matrix {rec['matrix']}: {ms:.3f} ms "
            f"median of 7, {fl / ms / 1e6:.1f} GFLOP/s ({fl / 1e9:.3f} GFLOP counted), "
            f"peak {peak / 2 ** 20:.1f} MiB above the inputs, card {card}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
