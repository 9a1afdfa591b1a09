"""The 1F1B pipeline schedule over the 'pp' slice (the port of
`paddle_tpu/distributed/pipeline_1f1b.py`; ref fluid/optimizer.py:3718
PipelineOptimizer and framework/section_worker.cc Run1F1B).

The (S stages, M microbatches) timetable is simulated on the host
(`simulate_1f1b`, a copy of the JAX package's: the same tables) into
action tables DO_F/F_M/DO_B/B_M and arrival tables RECV_F/F_RM/RECV_B/
B_RM of shape [T, S]. The JAX package runs them as one shard_map program
whose stages `lax.cond` on their column; here one process is one stage
and runs its column on `pipeline.run_schedule`'s tick engine, every
tick's sends and receives paired in one `batch_isend_irecv`:

  - a stage keeps at most S - r inputs in flight (the table's cap): an F
    tick runs the stage without autograd and banks only its input (and
    the random draws it made, `incubate.recompute`'s draw tape);
  - at its B tick the stage recomputes itself under autograd from the
    saved input, with the same draws, and pulls the received cotangent
    through (the reference's recompute + pipeline composition);
  - the last stage fuses stage, head and loss: its F tick banks the
    input, and the loss appears on its B tick.

1F1B buys memory, not bubble: a stage holds at most S - r microbatches'
inputs instead of GPipe's M autograd graphs. `OneF1BTrainStep` is
`pipeline.PipelineTrainStep` on these tables; it composes with 'dp' and
'mp' as that step does.
"""
import contextlib

import numpy as np
import torch

from ..incubate.recompute import _DrawTape
from . import collective
from . import mesh as mesh_mod
from .pipeline import PipelineTrainStep, _tables, run_schedule


def simulate_1f1b(S, M):
    """Host-side schedule simulation (the depth-first 1F1B rule: a stage
    runs a backward whenever one is ready, else a forward, with in-flight
    capped at S - r — ref section_worker.cc Run1F1B / Megatron's
    non-interleaved schedule). One compute slot per (tick, stage).

    Returns action tables of shape [T, S]:
      DO_F/F_M     stage computes forward of microbatch F_M
      DO_B/B_M     stage computes backward of microbatch B_M
      RECV_F/F_RM  an activation for microbatch F_RM arrives from upstream
                   (sent on the previous tick) and must be banked
      RECV_B/B_RM  a cotangent arrives from downstream and must be banked
    plus stats (T, max in-flight per stage, bubble_fraction) for tests."""
    fwd_done = [0] * S          # forwards computed per stage
    bwd_done = [0] * S
    arr_f = [0] * S             # activations banked (arr_f[0] ~ injection)
    arr_b = [0] * S             # cotangents banked
    DO_F, F_M, DO_B, B_M = [], [], [], []
    RECV_F, F_RM, RECV_B, B_RM = [], [], [], []
    max_inflight = [0] * S
    t = 0
    while min(bwd_done) < M and t < 8 * (M + 2 * S) + 16:
        # arrivals: what neighbors computed on the previous tick lands now
        recv_f = [False] * S
        f_rm = [0] * S
        recv_b = [False] * S
        b_rm = [0] * S
        if t > 0:
            for r in range(1, S):
                if DO_F[-1][r - 1]:
                    recv_f[r] = True
                    f_rm[r] = F_M[-1][r - 1]
                    arr_f[r] += 1
            for r in range(S - 1):
                if DO_B[-1][r + 1]:
                    recv_b[r] = True
                    b_rm[r] = B_M[-1][r + 1]
                    arr_b[r] += 1
        do_f = [False] * S
        f_m = [0] * S
        do_b = [False] * S
        b_m = [0] * S
        for r in range(S):
            mf, mb_ = fwd_done[r], bwd_done[r]
            can_f = mf < M and (mf < arr_f[r] if r else True) \
                and (mf - mb_) < (S - r)          # 1F1B in-flight cap
            can_b = mb_ < M and (mb_ < arr_b[r] if r < S - 1
                                 else mb_ < fwd_done[r])
            if can_b:                             # depth-first: drain bwds
                do_b[r] = True
                b_m[r] = mb_
                bwd_done[r] = mb_ + 1
            elif can_f:
                do_f[r] = True
                f_m[r] = mf
                fwd_done[r] = mf + 1
        DO_F.append(do_f)
        F_M.append(f_m)
        DO_B.append(do_b)
        B_M.append(b_m)
        RECV_F.append(recv_f)
        F_RM.append(f_rm)
        RECV_B.append(recv_b)
        B_RM.append(b_rm)
        for r in range(S):
            max_inflight[r] = max(max_inflight[r],
                                  fwd_done[r] - bwd_done[r])
        t += 1
    assert min(bwd_done) >= M, "1F1B schedule did not converge"
    busy = int(np.sum(DO_F) + np.sum(DO_B))
    return {
        "DO_F": np.asarray(DO_F), "F_M": np.asarray(F_M, np.int32),
        "DO_B": np.asarray(DO_B), "B_M": np.asarray(B_M, np.int32),
        "RECV_F": np.asarray(RECV_F), "F_RM": np.asarray(F_RM, np.int32),
        "RECV_B": np.asarray(RECV_B), "B_RM": np.asarray(B_RM, np.int32),
        "T": t, "max_inflight": max_inflight,
        "bubble_fraction": 1.0 - busy / float(t * S),
    }


def _replaying(tape):
    return tape.run() if tape is not None else contextlib.nullcontext()


def one_f1b_stage(first, last, n_micro, inp, stage, head, loss_acc):
    """The (forward, backward) tick callbacks of one stage's 1F1B column
    (`run_schedule`'s), shared by `pipeline_1f1b` and `OneF1BTrainStep`:

      inp(m)      the first stage's input of microbatch m
      stage(x)    the stage's chunk
      head(y, m)  the last stage's loss of microbatch m (a torch scalar)
      loss_acc    a float32 scalar the losses are added to (in place)

    A forward tick runs the stage without autograd and keeps only its
    input and its draws (the last stage keeps its input alone); the
    backward tick recomputes the stage under autograd from it, the draws
    replayed, and pulls the cotangent (on the last stage, the loss /
    n_micro) into the leaves' grads; it returns the input's cotangent."""
    keep = {}

    def forward(m, x):
        if last:
            keep[m] = (x, None)
            return None
        tape = _DrawTape()
        with torch.no_grad(), tape.run():
            y = stage(inp(m) if first else x)
        keep[m] = (x, tape)
        return y

    def backward(m, cot):
        x, tape = keep.pop(m)
        with _replaying(tape):
            if first:
                x = inp(m)
            else:
                x.requires_grad_(True)
            y = stage(x)
        if last:
            share = head(y, m)
            loss_acc.add_(share.detach().float())
            (share / n_micro).backward()
        else:
            torch.autograd.backward(y, cot)
        return None if first else x.grad

    return forward, backward


def pipeline_1f1b(stage_fn, last_loss_fn, blocks_p, post_p, x_micro,
                  labels_micro, mesh=None, pp_axis=None):
    """Run 1F1B over the 'pp' slice, this process being its stage.

    stage_fn(stage_params, x) -> y            this stage's forward chunk
    last_loss_fn(stage_params, post_params, x, labels) -> scalar microloss
        (the last stage's chunk + head + loss, fused)
    blocks_p: this stage's params (name -> torch tensor)
    post_p:   the head's and norm's params (read on the last stage)
    x_micro:  [M, mb, ...] first-stage inputs (read on the first stage;
              its shape and dtype are every activation's);
    labels_micro: [M, ...] (read on the last stage)

    Returns (mean loss, on every rank of the slice; this stage's grads
    of blocks_p; the grads of post_p, zeros off the last stage; dx_micro,
    the first stage's input cotangents, zeros elsewhere) — dx_micro
    feeds the embedding backward outside the engine, as in the JAX
    package."""
    mesh = mesh or mesh_mod.get_mesh()
    axis = pp_axis or mesh_mod.PP_AXIS
    S, r, pg = mesh.axis_size(axis), mesh.axis_index(axis), mesh.group(axis)
    M = int(x_micro.shape[0])
    first, last = r == 0, r == S - 1
    bp = {n: a.detach().requires_grad_(True) for n, a in blocks_p.items()}
    pp = {n: a.detach().requires_grad_(True) for n, a in post_p.items()}
    xs = {}

    def inp(m):
        xs[m] = x_micro[m].detach().requires_grad_(True)
        return xs[m]

    def stage(x):
        # the last stage's chunk runs fused with its head
        return x if last else stage_fn(bp, x)

    def head(y, m):
        return last_loss_fn(bp, pp, y, labels_micro[m])

    loss_acc = torch.zeros((), dtype=torch.float32, device=x_micro.device)
    run_schedule(_tables(simulate_1f1b(S, M)), r, S, pg,
                 tuple(x_micro.shape[1:]), x_micro.dtype, x_micro.device,
                 *one_f1b_stage(first, last, M, inp, stage, head, loss_acc))
    loss = loss_acc / M
    collective.broadcast_(loss, S - 1, pg)

    def grads(leaves):
        return {n: torch.zeros_like(a) if a.grad is None else a.grad
                for n, a in leaves.items()}
    dx_micro = torch.stack([xs[m].grad for m in range(M)]) if first \
        else torch.zeros_like(x_micro)
    return loss, grads(bp), grads(pp), dx_micro


class OneF1BTrainStep(PipelineTrainStep):
    """The 1F1B training step over a mesh with a 'pp' axis — pure-pp or
    composed with 'dp' and 'mp' (the memory-lean alternative to
    `pipeline.PipelineTrainStep`'s GPipe; ref section_worker.cc Run1F1B
    + pipeline_optimizer.py:232 pipeline x DP composition). Accepts any
    model decomposable via `pipeline.PipelineParts`, not just GPT.
    Dropout replays: a stage's recompute draws what its forward drew."""

    schedule = "1f1b"

    def __init__(self, model, loss_fn, optimizer, mesh=None, num_micro=8,
                 num_stages=None, donate=True, parts=None, cuda_graph=True):
        super().__init__(model, loss_fn, optimizer, mesh=mesh,
                         num_micro=num_micro, num_stages=num_stages,
                         remat=False, donate=donate, parts=parts,
                         cuda_graph=cuda_graph)

    def _callbacks(self):
        """`one_f1b_stage` over this stage: `pre` on the first, the
        stage's blocks, the head and loss on the last."""
        return one_f1b_stage(
            self.first, self.last, self.num_micro,
            lambda m: self._pre(self._ids_m[m]),
            lambda x: self._trunk(x, False),
            lambda y, m: self._head(y, self._lab_m[m]), self._loss_acc)
