"""The general traffic generator: one loop per kind of traffic file.

* ``theta_closed_loop`` — one client, the INLA θ-sweep: each step draws
  ``batch`` candidates ``τ A + δ I`` from the seed, builds them on the card
  from the base matrix, runs ``factorize_window_batched`` + ``logdet`` and
  the read-out (``solve_many_batched`` of ``k`` seeded columns, or
  ``selinv_batched`` and the marginal variances), and reads the results
  back to the host before the next step: the optimizer needs them to
  propose the next batch.
* ``served_open_loop`` — a client that submits single candidates, each
  with its own seeded ``k``-column panel, to the rung server on the real
  clock at a fixed rate.  The gaps between arrivals are ``request_stream``'s
  for a fixed arrival seed; the run's seed permutes them, so every seed
  offers the same arrivals in another order.  The client builds requests
  on the card a chunk at a time, in a few launches for the chunk, ahead of
  their due times, so its host work in the window is mostly sending and
  collecting.  A request's latency runs
  from its due time to its future resolving; a request that fails, is shed
  or never comes counts as infinitely late.

A loop's ``setup`` makes its inputs and warms the shapes its traffic uses;
``window`` runs the measured window; ``answers`` hands back the answers of
the candidates the comparison samples, and ``reference_answers`` the plain
reference's for the same candidates.
"""
from __future__ import annotations

import collections
import math
import time

import numpy as np
import torch

from . import program
from .frozen.synthetic import request_stream
from .frozen.theta import Candidates, Layout, stream_seed, theta_draws

__all__ = ["ThetaLoop", "ServedLoop", "LOOPS"]

# steps of the warm-up are numbered from here, apart from the window's
WARM_STEP = 1 << 40


class ThetaLoop:
    def __init__(self, cfg, mix, A, seed: int, device, tracer):
        self.cfg, self.mix, self.A, self.seed = cfg, mix, A, int(seed)
        self.device, self.tracer = torch.device(device), tracer
        self.layout = Layout(cfg["n"], cfg["arrow"], cfg["t"])
        self.batch, self.readout, self.k = mix["batch"], mix["readout"], mix.get("k", 1)

    def setup(self, seconds: float) -> None:
        self.base = program.base_matrix(self.A, self.cfg, self.device)
        self.make = Candidates(self.layout, self.device)
        # every shape the window runs, then steps for a while, so the window
        # starts in the steady state
        s, t0 = 0, time.perf_counter()
        while s < self.mix.get("warm_steps", 3) or time.perf_counter() - t0 < self.mix.get(
                "warm_seconds", 0.0):
            self.step(WARM_STEP + s)
            s += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _draws(self, s: int):
        return theta_draws(self.seed, s, self.batch, self.mix["tau"], self.mix["delta"])

    def _rhs(self, s: int) -> torch.Tensor:
        return self.make.rhs(self.batch, self.k, stream_seed(self.seed, 13, s))

    def step(self, s: int):
        """One θ step; returns its results on the host."""
        tr = self.tracer
        tau, delta = self._draws(s)
        with tr.span("build"):
            mb = program.batch_matrix(self.base, *self.make.make(
                self.base.Dr, self.base.R, self.base.C, tau, delta))
            B = self._rhs(s) if self.readout == "solve" else None
        with tr.span("factor"):
            f = program.factorize(mb)
            ld = program.logdet(f)
        if self.readout == "solve":
            with tr.span("solve"):
                out = program.solve(f, B)
        else:
            with tr.span("selinv"):
                out = program.selinv(f).diagonal()
        with tr.span("readback"):
            return ld.cpu(), f.status.cpu(), out.cpu()

    def window(self, seconds: float) -> dict:
        # every step's log-determinants and status words are kept; its
        # solutions or variances only for a few steps drawn from the seed
        # and for the last, so the host's memory does not grow in the window
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 6]))
        keep = rng.random(1 << 16) < 1.0 / self.mix.get("keep_every", 64)
        logdets, statuses, kept = [], [], {}
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            s = len(statuses)
            ld, st, res = self.step(s)
            logdets.append(ld)
            statuses.append(st)
            if keep[s % len(keep)]:
                kept[s] = res
            last = (s, res)
        t1 = time.perf_counter()
        if statuses:
            kept[last[0]] = last[1]
        self.logdets, self.kept = logdets, kept
        status = torch.stack(statuses) if statuses else torch.zeros((0, self.batch, 3))
        bad = int(((status[..., 1] != 0) | (status[..., 2] != -1)).sum())
        n = len(statuses) * self.batch
        return {"t0": t0, "t1": t1, "window_s": t1 - t0, "steps": len(statuses),
                "attempted": n, "completed": n, "failed": bad, "bad_status": bad}

    def release(self) -> None:
        self.base = self.make = None

    def answers(self) -> list:
        """The answers of the steps the comparison checks: the last step's
        and others drawn from the seed among the steps kept."""
        if not self.kept:
            self.sampled = []
            return []
        last = max(self.kept)
        rest = sorted(set(self.kept) - {last})
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 5]))
        pick = rng.choice(len(rest), size=min(len(rest), self.mix["check_steps"] - 1),
                          replace=False) if rest else []
        self.sampled = sorted({rest[int(p)] for p in pick} | {last})
        out = []
        rows = self.layout.rows()
        for s in self.sampled:
            ld, res = self.logdets[s], self.kept[s]
            for i in range(self.batch):
                a = {"logdet": float(ld[i])}
                if self.readout == "solve":
                    a["x"] = res[i].numpy()[rows]
                else:
                    a["var"] = res[i].numpy()
                out.append(a)
        self.logdets = self.kept = None
        return out

    def reference_answers(self, ref) -> list:
        out = []
        rows = self.layout.rows()
        make = Candidates(self.layout, self.device)
        for s in self.sampled:
            tau, delta = self._draws(s)
            B = (make.rhs(self.batch, self.k, stream_seed(self.seed, 13, s)).cpu().numpy()
                 if self.readout == "solve" else None)
            for i in range(self.batch):
                L = ref.factor(tau[i], delta[i])
                a = {"logdet": ref.logdet(L)}
                if self.readout == "solve":
                    a["x"] = ref.solve(L, B[i][rows])
                else:
                    a["var"] = ref.variances(L)
                out.append(a)
                del L
        return out


class ServedLoop:
    def __init__(self, cfg, mix, A, seed: int, device, tracer):
        self.cfg, self.mix, self.A, self.seed = cfg, mix, A, int(seed)
        self.device, self.tracer = torch.device(device), tracer
        self.layout = Layout(cfg["n"], cfg["arrow"], cfg["t"])
        self.k = mix["k"]

    def arrivals(self, seconds: float) -> np.ndarray:
        """Due times from the window's start: ``request_stream``'s gaps for
        the mix's arrival seed, as many as the rate fills ``seconds`` with,
        in an order drawn from the run's seed."""
        m = max(1, int(round(self.mix["rate"] * seconds)))
        case = (self.cfg["n"], self.cfg["bandwidth"], self.cfg["arrow"])
        stream = request_stream(self.mix["arrival_seed"], [case], m, rate=self.mix["rate"],
                                burst_factor=self.mix.get("burst_factor", 1.0))
        gaps = np.diff([0.0] + [r["arrival"] for r in stream])
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 3]))
        return np.cumsum(gaps[rng.permutation(m)])

    def _theta(self, rid: int):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 2, rid]))
        return rng.uniform(*self.mix["tau"]), rng.uniform(*self.mix["delta"])

    def _rhs(self, make, chunk: int) -> torch.Tensor:
        return make.rhs(self.mix["build_chunk"], self.k, stream_seed(self.seed, 4, chunk))

    def requests(self, chunk: int) -> list:
        """The requests of ``chunk`` (``build_chunk`` of them from request
        ``chunk * build_chunk`` on), each a matrix and a panel, built on the
        card together in a few launches."""
        n = self.mix["build_chunk"]
        tau, delta = zip(*(self._theta(chunk * n + j) for j in range(n)))
        Dr, R, C = self.make.make(self.base.Dr, self.base.R, self.base.C, tau, delta)
        B = self._rhs(self.make, chunk)
        return [(program.batch_matrix(self.base, Dr[j], R[j], C[j]), B[j]) for j in range(n)]

    def setup(self, seconds: float) -> None:
        self.base = program.base_matrix(self.A, self.cfg, self.device)
        self.make = Candidates(self.layout, self.device)
        self.server = program.server(self.mix, self.device)
        # the pump thread started here serves the window too; one batch of
        # each padded size the server makes warms the batched entries, the
        # corner's graphs and the thread's own handles
        self.server.start()
        chunk = WARM_STEP
        for b in self.mix["warm_batches"]:
            futs = [self.server.submit(*r) for r in self.requests(chunk)[:b]]
            chunk += 1
            for f in futs:
                f.result(timeout=600)
        # then the mix's own traffic for a while, so the window starts in the
        # steady state: the allocator's pool grown, the clocks up
        warm = self.mix.get("warm_seconds", 0.0)
        if warm > 0:
            self._drive(self.arrivals(warm), chunk)
        self.due = self.arrivals(seconds)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _drive(self, due: np.ndarray, first_chunk: int, keep=frozenset()) -> dict:
        """Send requests at ``due`` seconds from now, collect each answer
        as it resolves, and wait for the last, a minute past the close at
        most.  The client builds the requests a chunk at a time, the next
        chunk as soon as fewer than a chunk are ready, so each is on the
        card before it is due.  Returns each request's latency from its due
        time (inf where it failed, was shed or never came), its status, the
        client's lag and the answers of the requests in ``keep``."""
        m = len(due)
        lat, lag, status = np.full(m, math.inf), np.zeros(m), np.full(m, -1)
        kept, pending, ready = {}, collections.deque(), collections.deque()
        chunk = first_chunk

        def collect(block_until=None):
            while pending:
                i, t_sub, fut = pending[0]
                if not fut.done():
                    if block_until is None or time.perf_counter() >= block_until:
                        return
                    time.sleep(2e-4)
                    continue
                pending.popleft()
                res = fut.result(timeout=0)
                status[i] = res.status
                if res.ok():
                    lat[i] = t_sub + res.wall_latency_s - (t0 + due[i])
                    if i in keep:
                        kept[i] = {"logdet": float(res.factor.logdet()),
                                   "x": res.x.cpu().numpy()}

        for _ in range(2):
            ready.extend(self.requests(chunk))
            chunk += 1
        t0 = time.perf_counter() + 0.05
        for i in range(m):
            at = t0 + due[i]
            while True:
                collect()
                now = time.perf_counter()
                if now >= at:
                    break
                time.sleep(min(at - now, 5e-4))
            t_sub = time.perf_counter()
            lag[i] = t_sub - at
            pending.append((i, t_sub, self.server.submit(*ready.popleft())))
            if len(ready) < self.mix["build_chunk"] and i + 1 + len(ready) < m:
                with self.tracer.span("build"):
                    ready.extend(self.requests(chunk))
                chunk += 1
        close = time.perf_counter()
        collect()
        unfinished = len(pending)
        collect(block_until=close + 60.0)
        return {"t0": t0, "close": close, "lat": lat, "lag": lag, "status": status,
                "kept": kept, "unfinished": unfinished}

    def window(self, seconds: float) -> dict:
        due = self.due
        m = len(due)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 5]))
        self.sampled = sorted(set(int(i) for i in rng.choice(
            m, size=min(m, self.mix["check_requests"]) - 1, replace=False)) | {m - 1})
        run = self._drive(due, 0, frozenset(self.sampled))
        self.server.stop()
        self.kept, self.lat, self.status = run["kept"], run["lat"], run["status"]
        lat, lag = run["lat"], run["lag"]
        failed = int(np.sum(~np.isfinite(lat)))
        # the 95th percentile by nearest rank over every request, failed ones
        # infinitely late
        p95 = float(np.sort(lat)[math.ceil(0.95 * m) - 1] * 1e3)
        return {"t0": run["t0"], "t1": run["close"], "window_s": run["close"] - run["t0"],
                "attempted": m, "completed": m - failed, "failed": failed, "bad_status": failed,
                "lag_p95_ms": float(np.sort(lag)[math.ceil(0.95 * m) - 1] * 1e3),
                "lag_max_ms": float(lag.max() * 1e3), "unfinished_at_close": run["unfinished"],
                "served_p95_ms": p95}

    def release(self) -> None:
        self.base = self.server = self.make = None

    def answers(self) -> list:
        rows = self.layout.rows()
        return [dict(self.kept[i], x=self.kept[i]["x"][rows]) if i in self.kept else {}
                for i in self.sampled]

    def reference_answers(self, ref) -> list:
        rows = self.layout.rows()
        out = []
        make = Candidates(self.layout, self.device)
        n = self.mix["build_chunk"]
        for i in self.sampled:
            tau, delta = self._theta(i)
            B = self._rhs(make, i // n)[i % n].cpu().numpy()
            L = ref.factor(tau, delta)
            out.append({"logdet": ref.logdet(L), "x": ref.solve(L, B[rows])})
            del L
        return out


LOOPS = {"theta_closed_loop": ThetaLoop, "served_open_loop": ServedLoop}
