"""Multi-pod dry run: prove the distribution config is coherent without
hardware.

For every (architecture × input shape × mesh) cell this runs the port's
real step — ``train_step`` with ``rules`` (loss + grad + AdamW, sharded as
``launch/train.py`` shards it) for train shapes, ``prefill`` for prefill
shapes, ``decode_step`` for decode shapes — as one rank of the
production mesh of a fake world of 256 or 512 ranks, the last of the first
``model`` group (``rank``: under the causal sequence split its query block
visits every key block, so it computes the most; the others hold the same
shapes), and records:

  * ``memory``: this rank's argument bytes (the state's, caches' and
    batch's blocks by the rules), output bytes, and the peak of live bytes
    over the call (``temp_bytes`` is the peak less the arguments; an
    in-place update's outputs alias its arguments);
  * ``cost_scanned``: FLOPs (``torch.utils.flop_counter.FlopCounterMode``)
    and the bytes of every operation's inputs and outputs;
  * ``collectives_scanned``: operand bytes of every collective the step
    asked for, from the fake transport's records;
  * ``cost_extrapolated`` / ``cost_per_layer``: the same from 1- and
    2-layer runs of the cell.

Stand-in for the reference's 512 forced XLA host devices: a process group
of the ``fake`` backend (``launch/mesh.py::fake_world``, this process the
rank above), whose collectives move nothing and are recorded by
``sharding/collectives.py``'s fake transport, and ``FakeTensorMode``
tensors on ``--device``: shapes, dtypes and devices without storage, so
nothing is allocated and no card is needed.  The default device is
``cuda`` where this torch is built with CUDA, ``cpu`` where it is not (a
CPU-only build cannot index or differentiate even fake CUDA tensors); the
record names it.  Parameter shapes come from the family's ``init`` under the
fake mode with a CPU generator (no random number is drawn); the step and
the count are host integers, since a fake tensor cannot be read.  Live
bytes are tracked by a dispatch mode: an operation's output storage lives
while a tensor on it does (autograd's saved tensors included).

What it counts that XLA's cost analysis does not: every trip of every
loop (layers, attention blocks, loss chunks, SSD chunks), so the scanned
FLOPs, collective bytes and unfused bytes equal the extrapolated ones (the
layer loop takes its slices by one ``unbind``).  What it does not count:
fusion — the bytes are every operation's inputs and outputs, unfused, an
upper bound of what a fused step moves; and the peak is eager PyTorch's
without its caching allocator's rounding.  Every cell runs the split
(``sharding/split.py``) on this rank's blocks: each layer gathered over
``data`` inside the layer loop, the compute split over ``model`` (TP, SP,
EP; the SSD mixer by heads with ``run.ssm_head_shard``, else by
sequence blocks), so its memory, FLOPs and collectives are the split's.  A train cell runs the
sharded step; a prefill cell ``prefill(constrain=)`` on the batch's block,
its caches coming out as blocks in the rules' cache layout; a decode cell
``decode_step(constrain=)`` on the caches' blocks
(``Rules.cache_shardings``: batch on ``data``, the K/V caches' sequence on
``model``, the SSD state by heads, the conv buffer by channels), which it
updates in place, attending by flash decoding over ``model``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --arch command-r-plus-104b --shape train_4k \
      --no-extrapolate --layers 2 --parts
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import weakref
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, pytree
from repro_torch.configs.base import ModelConfig, RunConfig, SHAPES, ShapeConfig
from repro_torch.models.registry import get_model, input_specs, supports_shape
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding import collectives
from repro_torch.sharding.partition import Rules, make_rules, shard_shape
from repro_torch.sharding.split import Split
from .mesh import PRODUCTION_SHAPES, fake_world, make_production_mesh
from .train import TrainState, make_train_step, shard_train_step

__all__ = ["dryrun_cell", "collective_bytes", "default_device", "print_parts", "main"]

_DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2, "int64": 8,
                "int32": 4, "int16": 2, "uint8": 1, "int8": 1, "bool": 1}


def collective_bytes(records: Iterable[dict]) -> Dict[str, float]:
    """Sum the operand bytes of every collective record (``{"op",
    "dtype", "shape", "group"}``, the result's shape and the group's size,
    as the fake transport writes them).

    Operand size derivation from the result bytes R and group size g, as
    the reference's HLO parser has it:
      all-reduce / all-to-all / collective-permute : R
      all-gather                                   : R / g
      reduce-scatter                               : R * g
    """
    out: Dict[str, float] = {}
    for r in records:
        result = float(math.prod(r["shape"]) * _DTYPE_BYTES.get(r["dtype"], 4))
        g = max(1, int(r["group"]))
        op = r["op"]
        if op == "all-gather":
            operand = result / g
        elif op == "reduce-scatter":
            operand = result * g
        else:
            operand = result
        out[op] = out.get(op, 0.0) + operand
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def _reduced_layers(cfg: ModelConfig, n: int) -> ModelConfig:
    upd: Dict[str, Any] = {}
    if cfg.family == "hybrid":
        upd["n_layers"] = n * cfg.shared_attn_every
    else:
        upd["n_layers"] = n
    if cfg.family == "encdec":
        upd["encoder_layers"] = n
    return dataclasses.replace(cfg, **upd)


def _layer_count(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _part() -> str:
    """The part of the step an operation belongs to: the innermost function
    of the port's models on the Python stack (``file::qualified name``)
    and, where it called into the sharding package, the outermost function
    there; else that sharding function, else the autograd node running
    the operation; ``bwd`` inside a backward pass, ``fwd`` outside."""
    node = torch._C._current_autograd_node()
    model = shard = None
    f = sys._getframe(2)
    while f is not None and model is None:
        name = f.f_code.co_filename.replace(os.sep, "/")
        tag = f"{name.rsplit('/repro_torch/', 1)[-1]}::{f.f_code.co_qualname}"
        if "/repro_torch/models/" in name:
            model = tag
        elif "/repro_torch/sharding/" in name:
            shard = tag
        f = f.f_back
    tag = " > ".join(t for t in (model, shard) if t) or (
        node.name() if node is not None else "step")
    return ("bwd " if node is not None else "fwd ") + tag


class _Meter(torch.utils._python_dispatch.TorchDispatchMode):
    """Live bytes (each output storage counted while a tensor on it lives),
    their peak, and the bytes of every non-view operation's tensor inputs
    and outputs.  ``base`` is the arguments' bytes and ``held`` their
    tensors, whose storages are counted in ``base`` once for the whole
    call (a view of one, a layer's slice of a stacked leaf, adds
    nothing).  With ``parts``, each storage is charged to the part that
    made it (:func:`_part`): ``at_peak`` is the live bytes of each part at
    the peak (the arguments under ``args``), ``reach`` the most live bytes
    while each part ran."""

    def __init__(self, base: int, held=(), parts: bool = False):
        super().__init__()
        self.live = self.peak = base
        self.moved = 0
        self._refs: Dict[int, List[int]] = {}
        for t in held:
            st = t.untyped_storage()
            self._refs[st._cdata] = [st.nbytes(), 1]      # never dropped
        self.base, self.parts = base, parts
        self._owner: Dict[int, str] = {}         # the storages made here: their parts
        self.at_peak: Dict[str, int] = {"args": base}
        self.reach: Dict[str, int] = {}

    def _drop(self, key):
        ref = self._refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]
            self._owner.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat_out = [t for t in torch.utils._pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.moved += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in flat_out)
        part = _part() if self.parts else None
        for t in flat_out:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._refs:
                self._refs[key] = [st.nbytes(), 0]
                self.live += st.nbytes()
                if part is not None:
                    self._owner[key] = part
            self._refs[key][1] += 1
            weakref.finalize(t, self._drop, key)
        if part is not None:
            self.reach[part] = max(self.reach.get(part, 0), self.live)
            if self.live > self.peak:
                at = {"args": self.base}
                for key, owner in self._owner.items():
                    at[owner] = at.get(owner, 0) + self._refs[key][0]
                self.at_peak = at
        self.peak = max(self.peak, self.live)
        return out


def default_device() -> str:
    """``cuda`` where this torch is built with CUDA (a card need not be
    present), else ``cpu``."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _empty(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _blocks(full, shardings, device):
    """Fake tensors on ``device`` of this rank's block shapes of ``full``'s
    leaves."""
    return pytree.tree_map(lambda x, sh: _empty(shard_shape(tuple(x.shape), sh), x.dtype,
                                                device), full, shardings)


def _tree_bytes(tree) -> int:
    return sum(_nbytes(x) for x in pytree.leaves(tree) if isinstance(x, torch.Tensor))


def _measure(fn, args_bytes: int, held=(), parts: bool = False):
    """Run ``fn()`` under the meter and the FLOP counter (``held``: the
    argument tensors, :class:`_Meter`); returns its output and the
    readings."""
    from torch.utils.flop_counter import FlopCounterMode
    collectives.fake_records.clear()
    held = [t for t in pytree.leaves(held) if isinstance(t, torch.Tensor)]
    with _Meter(args_bytes, held, parts) as meter, FlopCounterMode(display=False) as flops:
        out = fn()
    records = list(collectives.fake_records)
    collectives.fake_records.clear()
    got = {"flops": float(flops.get_total_flops()), "bytes": float(meter.moved),
           "peak": meter.peak, "records": records}
    if parts:
        got["parts"] = {"at_peak": meter.at_peak, "reach": meter.reach}
    return out, got


def _run_cell(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig, rules: Rules,
              device: str, parts: bool = False) -> Dict[str, Any]:
    """One step of the cell as this rank, under a fake mode; returns the
    argument and output bytes and :func:`_measure`'s readings."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    api = get_model(cfg)
    dev = torch.device(device)
    with FakeTensorMode(allow_non_fake_inputs=True):
        full = api.init(torch.Generator(), cfg, shape.seq_len)
        param_sh = rules.param_shardings(full)
        params = _blocks(full, param_sh, dev)
        spec = pytree.tree_map(lambda x: _empty(x.shape, x.dtype, dev), input_specs(cfg, shape))

        if shape.kind == "train":
            f32 = lambda t: _empty(t.shape, torch.float32, dev)
            state = TrainState(params, AdamWState(m=pytree.tree_map(f32, params),
                                                  v=pytree.tree_map(f32, params),
                                                  count=np.int32(0)), np.int32(0))
            step = make_train_step(cfg, run, rules)
            fn, state_sh = shard_train_step(step, rules.mesh, rules,
                                            TrainState(full, None, None), spec)
            args = (_tree_bytes(state) + 8
                    + sum(math.prod(shard_shape(tuple(x.shape), rules.batch_specs(spec)[k]))
                          * x.element_size() for k, x in spec.items()))
            (state, metrics), r = _measure(lambda: fn(state, spec), args, (state, spec), parts)
            out_bytes = _tree_bytes((state.params, state.opt.m, state.opt.v)) + 8 + _tree_bytes(
                {k: v for k, v in metrics.items() if isinstance(v, torch.Tensor)})
            alias = out_bytes - _tree_bytes({k: v for k, v in metrics.items()
                                             if isinstance(v, torch.Tensor)})
            return {"args": args, "out": out_bytes, "alias": alias, **r}

        split = Split(rules).bind(params, rules.param_specs(full))
        if shape.kind == "prefill":
            bsh = rules.batch_specs(spec)
            batch = {k: _empty(shard_shape(tuple(x.shape), bsh[k]), x.dtype, dev)
                     for k, x in spec.items()}
            args = _tree_bytes(params) + _tree_bytes(batch)

            def prefill():
                with torch.no_grad():
                    return api.prefill(params, batch, cfg, run, constrain=split)

            out, r = _measure(prefill, args, (params, batch), parts)
            return {"args": args, "out": _tree_bytes(out), "alias": 0, **r}

        # decode: one new token against a seq_len cache, in the rules' blocks
        caches_full = api.init_cache(cfg, shape.global_batch, shape.seq_len, device="cpu")
        cache_sh = rules.cache_shardings(caches_full)
        caches = _blocks(caches_full, cache_sh, dev)
        split.bind(caches, pytree.tree_map(lambda sh: sh.spec, cache_sh))
        tsh = rules.batch_specs(spec)["token"]
        token = _empty(shard_shape(tuple(spec["token"].shape), tsh), torch.int32, dev)
        args = _tree_bytes(params) + _tree_bytes(caches) + _nbytes(token) + 4

        def decode():
            with torch.no_grad():
                return api.decode_step(params, caches, token, shape.seq_len - 1, cfg, run,
                                       constrain=split)[0]

        logits, r = _measure(decode, args, (params, caches, token), parts)
        return {"args": args, "out": _nbytes(logits) + _tree_bytes(caches),
                "alias": _tree_bytes(caches), **r}


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool = False,
                run: Optional[RunConfig] = None, extrapolate: bool = True,
                verbose: bool = True, device: Optional[str] = None,
                layers: Optional[int] = None, parts: bool = False) -> Dict[str, Any]:
    """Run one cell on a fake world; return the dry-run record.  ``layers``
    cuts the depth (a hybrid's superblocks, an encoder-decoder's both
    stacks; the record says so); ``parts`` adds the peak's parts
    (``memory["parts"]``: each part's live bytes at the peak and the most
    live bytes while it ran, :class:`_Meter`)."""
    device = device or default_device()
    cfg = configs.get(arch)
    if layers is not None:
        cfg = _reduced_layers(cfg, layers)
    shape = SHAPES[shape_name]
    run = run or RunConfig()
    skip = supports_shape(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "status": "skipped", "reason": skip}

    with fake_world(512 if multi_pod else 256, rank=PRODUCTION_SHAPES[multi_pod][-1] - 1):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = make_rules(mesh, cfg, run, shape)
        rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                               "mesh": "x".join(str(int(s)) for s in mesh.mesh.shape),
                               "status": "ok", "device": device,
                               "rank": dist.get_rank(), "run": dataclasses.asdict(run)}
        if layers is not None:
            rec["layers"] = _layer_count(cfg)
        t0 = time.time()
        got = _run_cell(cfg, shape, run, rules, device, parts)
        rec["run_s"] = round(time.time() - t0, 1)
        rec["memory"] = {
            "argument_bytes": int(got["args"]),
            "output_bytes": int(got["out"]),
            "temp_bytes": int(got["peak"] - got["args"]),
            "alias_bytes": int(got["alias"]),
            "peak_bytes": int(got["peak"]),
            "total_per_device_gib": round(got["peak"] / 2 ** 30, 3),
        }
        if parts:
            rec["memory"]["parts"] = got["parts"]
        rec["cost_scanned"] = {"flops": got["flops"], "bytes": got["bytes"]}
        rec["collectives_scanned"] = collective_bytes(got["records"])

        if extrapolate:
            per = {}
            for n in (1, 2):
                cfg_n = _reduced_layers(cfg, n)
                got_n = _run_cell(cfg_n, shape, run, make_rules(mesh, cfg_n, run, shape), device)
                per[n] = {"flops": got_n["flops"], "bytes": got_n["bytes"],
                          "coll": collective_bytes(got_n["records"])["total"]}
            L = _layer_count(cfg)
            rec["cost_extrapolated"] = {
                k: per[1][k] + (per[2][k] - per[1][k]) * (L - 1)
                for k in ("flops", "bytes", "coll")}
            rec["cost_per_layer"] = {k: per[2][k] - per[1][k]
                                     for k in ("flops", "bytes", "coll")}

    if verbose:
        mem = rec["memory"]["total_per_device_gib"]
        fl = rec.get("cost_extrapolated", rec["cost_scanned"])["flops"]
        print(f"[dryrun] {arch:24s} {shape_name:12s} mesh={rec['mesh']:8s} "
              f"mem/dev={mem:7.2f} GiB flops/dev={fl:.3e} "
              f"coll/dev={rec['collectives_scanned']['total']:.3e} B (run {rec['run_s']}s)")
    return rec


def print_parts(rec: Dict[str, Any], top: int = 12) -> None:
    """The ``top`` parts of a record's peak (:func:`dryrun_cell` with
    ``parts``), in GiB: what each holds at the peak, and the most live
    bytes while each ran."""
    gib = 2 ** 30
    parts = rec["memory"]["parts"]
    print(f"[dryrun] {rec['arch']} {rec['shape']}: the peak's parts (GiB held at the peak)")
    for name, nb in sorted(parts["at_peak"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {nb / gib:8.3f}  {name}")
    print(f"[dryrun] {rec['arch']} {rec['shape']}: the most GiB live while each part ran")
    for name, nb in sorted(parts["reach"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {nb / gib:8.3f}  {name}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Dry-run the sharded step of every "
                                            "(architecture x shape) cell on a fake world.")
    p.add_argument("--arch", choices=configs.ARCH_IDS)
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true",
                   help="run every (arch x shape) cell on this mesh")
    p.add_argument("--out", default=None, help="directory for JSON records")
    p.add_argument("--no-extrapolate", action="store_true")
    p.add_argument("--device", default=None,
                   help="device of the fake tensors (default: cuda where torch is built "
                        "with CUDA, else cpu)")
    p.add_argument("--layers", type=int, default=None,
                   help="cut every cell to this many layers (superblocks of a hybrid)")
    p.add_argument("--parts", type=int, nargs="?", const=12, default=0, metavar="N",
                   help="print the N (default 12) largest parts of each cell's peak: the "
                        "bytes each part holds at the peak and the most bytes live while "
                        "it ran")
    args = p.parse_args(argv)

    cells = []
    if args.all:
        for arch in configs.ARCH_IDS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    records = []
    for arch, shape in cells:
        try:
            rec = dryrun_cell(arch, shape, multi_pod=args.multi_pod,
                              extrapolate=not args.no_extrapolate, device=args.device,
                              layers=args.layers, parts=bool(args.parts))
            if args.parts:
                print_parts(rec, args.parts)
        except Exception as exc:  # record, keep going
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "mesh": "2x16x16" if args.multi_pod else "16x16",
                   "error": f"{type(exc).__name__}: {exc}"}
            print(f"[dryrun] {arch} {shape} FAILED: {rec['error']}")
        records.append(rec)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            mesh_tag = "multi" if args.multi_pod else "single"
            fn = os.path.join(args.out, f"{rec['arch']}_{rec['shape']}_{mesh_tag}.json")
            with open(fn, "w") as f:
                json.dump(rec, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"[dryrun] {n_ok} ok / {n_skip} skipped / {n_err} errors")
    if n_err:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
