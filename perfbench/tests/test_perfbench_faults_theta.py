"""The θ cells' comparison catches a broken timed path: a sound run is
correct; a factorization that returns its input unchanged, one that leaves
half of the batch out (the mean of the rest in its place), and an answer
altered where it is produced are not, nor is the control (the reference
with TF32 trailing updates in the program's place).  No θ cell exchanges
anything between chips, so that fault has no place here."""
import pytest
import torch

from perfbench import program
from perfbench.tests._faults import control, run
from repro_torch.core import BandedCTSF, CholeskyFactor

CELLS = ["table2-5.optimize", "table2-2.optimize", "table2-5.integrate"]


def unchanged(mb, **kw):
    clean = torch.tensor([1.0, 0.0, -1.0]).repeat(mb.Dr.shape[0], 1)
    return CholeskyFactor(mb, status=clean)


def half_batch(orig):
    def factorize(mb, **kw):
        h = mb.Dr.shape[0] // 2
        f = orig(BandedCTSF(mb.grid, *(x[:h] for x in mb.arrays())), **kw)
        arrays = [torch.cat([x, x.mean(0, keepdim=True).expand_as(x)])
                  for x in f.ctsf.arrays()]
        return CholeskyFactor(BandedCTSF(mb.grid, *arrays), status=torch.cat([f.status] * 2))
    return factorize


def altered_solve(orig):
    def solve(f, B, **kw):
        X = orig(f, B, **kw)
        X[:, 5, 0] += 1e-3 * X.abs().max()
        return X
    return solve


def altered_selinv(orig):
    def selinv(f, **kw):
        S = orig(f, **kw)
        S.Dr[:, 3, 0, 2, 2] *= 1.001
        return S
    return selinv


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    ok, checks = run(cell)
    assert ok, checks


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fault_is_caught(monkeypatch, cell, fault):
    if fault == "unchanged":
        monkeypatch.setattr(program, "factorize", unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(program, "factorize", half_batch(program.factorize))
    elif cell.endswith("integrate"):
        monkeypatch.setattr(program, "selinv", altered_selinv(program.selinv))
    else:
        monkeypatch.setattr(program, "solve", altered_solve(program.solve))
    ok, checks = run(cell)
    assert not ok, checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    ok, nums = control(cell)
    assert not ok, nums
