"""K3's alpha and tail modes and K2's tail (with p's update) of a parent
checkout against this checkout's, in one process, and this checkout's
guarded forms beside them:

    python -m tpucg_torch.bench.lap_ab PARENT_ROOT [--n 8192] [--reps 3] [--copies 3]

``PARENT_ROOT`` is a checkout of the parent (``git archive`` of it unpacked
into an ignored directory). Its ``tpucg_torch.kernels.blas1`` is imported
beside this checkout's (``probe_ab.parent_module``), so each side launches
through its own launch cores and C entry points on its own kernel library.
Each case runs the lap's launch cores as ``chip_smoke.py`` phase 6 times
them (one scratch zeroed once; the tail's tol^2 = 0, so it never stops),
both sides on the same operands (``LapOperands``), on ``--copies`` sets at
other addresses: first once on each side from the same state, held bit for
bit (alpha, x', r', r'.r', the tail's scalars and p), then timed ``--reps``
times in turns (parent first, then change first), µs a call queued behind a
spin kernel. The guarded forms run on this checkout's side only. Then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from tpucg_torch.bench.probe_ab import parent_module
from tpucg_torch.bench.timing import device_seconds_per_call, nvidia_smi_card
from tpucg_torch.kernels import blas1
from tpucg_torch.kernels.dispatch import cuda_stream

CASES = ("K3 alpha", "K3 tail", "K2 + tail + p update")


class LapOperands:
    """One set of the lap's operands at n (made from ``seed``), with the
    lap's scalars in a ``CudaLapTail`` (tol^2 = 0, so the tail never stops;
    the parent's ``LapScalars`` has the same layout) and one scratch. Every
    side launches on the same set, so no address differs between them;
    ``reset`` puts the written state back before each side's run."""

    def __init__(self, dev, n: int, seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.x, self.r, self.p, self.ap, self.z = (
            2 * torch.rand(n, generator=gen, device=dev) - 1 for _ in range(5))
        self.stream = cuda_stream(self.x)
        self.scratch = blas1.scratch_for(self.x)
        self.tail = blas1.CudaLapTail(dev)
        self.out, self.alpha = torch.empty((), device=dev), torch.empty((), device=dev)
        self.xo, self.ro, self.p2 = (torch.empty_like(self.x) for _ in range(3))
        self.reset()

    def reset(self) -> None:
        self.tail.load(torch.tensor(0, dtype=torch.int32), torch.tensor(2.5),
                       torch.tensor(1.0), torch.tensor(False),
                       torch.zeros((), device=self.x.device), 2 ** 31 - 1)
        self.tail.rr.fill_(0.75)
        self.alpha.fill_(0.37)
        self.p2.copy_(self.p)

    def written(self, label: str) -> list:
        t = self.tail
        if label == "K3 alpha":
            return [self.out, self.alpha]
        if label == "K3 tail":
            return [self.out, t.k, t.rsold, t.rslast, t.beta, t.step]
        return [self.xo, self.ro, t.rr, t.k, t.rsold, t.beta, self.p2]


def lap_cases(blas, o: LapOperands, guard: Optional[bool] = None) -> dict:
    """``{label: call}``: the three launch sequences through ``blas`` (a
    ``kernels.blas1`` module, this checkout's or a parent's) on the
    operands ``o``; ``guard`` (this checkout only) picks the guarded
    forms."""
    kw = {} if guard is None else {"guard": guard}
    t = o.tail

    def k3_alpha():
        blas.dot_alpha_launch(o.p, o.ap, o.scratch, o.out, t.rsold, o.alpha, True, None,
                              o.stream, **kw)

    def k3_tail():
        blas.dot_tail_launch(o.r, o.z, o.scratch, o.out, t.address, o.stream, **kw)

    def k2_lap():
        blas.fused_update_tail_launch(o.x, o.r, o.p2, o.ap, o.alpha, o.xo, o.ro, o.scratch,
                                      t.rr, t.address, o.stream, **kw)
        blas.p_update_launch(o.ro, o.p2, t.beta, t.step, o.scratch, o.stream)
    return dict(zip(CASES, (k3_alpha, k3_tail, k2_lap)))


def _same(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpucg_torch.bench.lap_ab",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", metavar="PARENT_ROOT", help="a checkout of the parent")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--copies", type=int, default=3, help="operand sets, each at its own address")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("lap_ab measures on the card, and there is no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    parent = parent_module(args.parent, "kernels.blas1")
    card = nvidia_smi_card()
    print(f"device: {torch.cuda.get_device_name(dev)} [{card}]; parent {args.parent}; n = "
          f"{args.n}; µs a call, queued", flush=True)
    for c in range(args.copies):
        o = LapOperands(dev, args.n, seed=c)
        sides = {"parent": lap_cases(parent, o), "change": lap_cases(blas1, o),
                 "change guarded": lap_cases(blas1, o, guard=True)}
        for label in CASES:
            got = {}
            for k in ("parent", "change"):
                o.reset()
                sides[k][label]()
                torch.cuda.synchronize()
                got[k] = [t.clone() for t in o.written(label)]
            if not all(_same(a, b) for a, b in zip(got["parent"], got["change"])):
                raise RuntimeError(f"{label}: the parent's launches and the change's differ")
            us = {k: [] for k in sides}
            for rep in range(args.reps):
                order = ("parent", "change") if rep % 2 == 0 else ("change", "parent")
                for k in order + ("change guarded",):
                    o.reset()
                    us[k].append(device_seconds_per_call(sides[k][label]) * 1e6)
            print(f"{label}, operand set {c} (0x{o.x.data_ptr():x}): bit-identical to the "
                  "parent; " + "; ".join(f"{k} " + "/".join(f"{v:.3f}" for v in vals)
                                          for k, vals in us.items()), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
