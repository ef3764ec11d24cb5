"""The served mix's comparison catches a broken timed path inside the rung
server: a solve that returns its panels unchanged, one that leaves half of
the batch out (the mean of the rest in its place), and an answer altered
where it is produced; the control fails it too.  A sound run is correct.
No cell of ``BENCHMARK.json`` runs the mix yet (``PERF.md`` says why), so
the tests add the cell a later change would add, ``table2-5.served``, to a
copy of the manifest.  It runs on one chip: there is no exchange between
chips to leave out."""
import pytest

import repro_torch.launch.rung_server as rs
from perfbench.tests._faults import control, run, with_cell

CELL = "table2-5.served"
MIX = {"rate": 40.0, "check_requests": 6, "warm_batches": [1, 2]}


@pytest.fixture
def root(tmp_path):
    return with_cell(tmp_path, {"name": CELL, "config": "table2-5", "traffic": "served",
                                "chips": 1, "why": "served candidates"})


def unchanged(f, B, **kw):
    return B.clone()


def half_batch(orig):
    def solve(f, B, **kw):
        X = orig(f, B, **kw)
        h = max(1, X.shape[0] // 2)
        X[h:] = X[:h].mean(0, keepdim=True)
        return X
    return solve


def altered(orig):
    # the batch sits on the rung's canonical grid behind an identity prefix:
    # the whole first column of every answer is scaled
    def solve(f, B, **kw):
        X = orig(f, B, **kw)
        X[:, :, 0] *= 1.01
        return X
    return solve


def test_sound_run_is_correct(root):
    ok, checks = run(CELL, MIX, root=root)
    assert ok, checks


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fault_is_caught(monkeypatch, root, fault):
    orig = rs.solve_many_batched
    monkeypatch.setattr(rs, "solve_many_batched",
                        {"unchanged": unchanged, "half_batch": half_batch(orig),
                         "altered": altered(orig)}[fault])
    ok, checks = run(CELL, dict(MIX, rate=80.0), root=root)
    assert not ok, checks


def test_control_is_not_correct(root):
    ok, nums = control(CELL, MIX, root=root)
    assert not ok, nums
