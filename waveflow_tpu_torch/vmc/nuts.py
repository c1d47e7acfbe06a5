"""No-U-Turn Sampler: dynamic trajectory lengths, chains batched by masks.

Port of waveflow_tpu/vmc/nuts.py: the iterative NUTS of
Hoffman & Gelman (2014, Alg. 3) in its checkpointed form —

* the trajectory doubles, in a random direction, up to ``max_tree_depth``
  times;
* progressive **multinomial** sampling of the proposal within each
  subtree, and biased progressive sampling across subtrees;
* the **full dyadic U-turn criterion**: every balanced block of a subtree
  that ends at leaf i (i + 1 ≡ 0 mod 2^k) is checked against its start
  leaf s = i + 1 − 2^k, kept in checkpoint slot ``slot(s)`` (its trailing
  zeros; ``max_tree_depth`` for leaf 0), which no interior leaf
  overwrites;
* the divergence guard (energy error above 1000, or NaN: ROADMAP Queue 3)
  and the same dual-averaging warm-up as vmc/hmc.py.

The chains of a batch step in lockstep: every chain's subtree is at the
same leaf, and a chain whose tree has stopped keeps its state under a
mask, as a lane of JAX's vmapped ``while_loop`` does.  Every leaf
evaluates the gradient of the whole batch, as that loop evaluates every
lane.  A step costs one gradient evaluation of the batch at its start and
one per leaf: the gradient at a leaf starts the next.

A step runs as five bodies over static tensors written in place (the
state, the step's draws, the trajectory's ends and proposal, the
subtree's running sums and checkpoints, the leaf index i and the doubling
index j, each on the device): the step's start, a subtree's start, a
leaf, a merge, and the step's end (one body for a warm-up step, one for a
kept step).  No body reads a value back to the host: leaf i of doubling j
finds its uniform at column 2^j − 1 + i, its checkpoint slot and the
blocks that end at it from the slots i and j, and checks every block size
2^k ≤ 2^max_tree_depth under the mask ``(i + 1) mod 2^k = 0 and k ≤ j``,
as JAX's body does.  So one body serves every leaf of every doubling.
The host loop calls them, and reads the device twice over: whether any
chain still builds (``live.any()``) after each leaf but a subtree's last,
and whether any chain's tree goes on (``active.any()``) after each merge
but the last doubling's, only to end the step once every chain has
stopped — JAX's GPU ``while_loop`` reads its predicate as often.

JAX compiles the step, and scans the steps.  On a CUDA device ``run_fn``
replays each body as a CUDA graph (vmc/graphs.py): a run makes six
captures at most, each body's on its first call (the warm-up end only when
there are warm-up steps), and keeps them for the next call at the same
shape, device and generator, one set at a time.  A step of n leaves over
d doublings is 2 + 2d + n replays.  Elsewhere, and in ``step_fn``, the
same bodies run eagerly (``graphs.Epochs``).

Chains sharded over ranks (``axis_name``): the mean acceptance statistic
of a warm-up step is ``pmean``-reduced over the ranks in the step's end,
the run's only collective (captured with it under NCCL), as in JAX, whose
per-device ``while_loop``s run independently (a kept step's reduction is
unused, and not made).  The host reads stay rank-local, so ranks build
trees of their own lengths; every rank then makes that one collective per
warm-up step, and must: a rank that skips one deadlocks the world.

Every random number of a step is drawn up front (``draw``, inside the
step's start on the graph path, so that a replay advances the generator
as the eager step does): the momentum, the direction bits, one uniform per
leaf and one per merge.  ``step_fn`` takes them as tensors, so a test can
replay the JAX package's key tree into it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from waveflow_tpu_torch.parallel import mesh
from waveflow_tpu_torch.vmc import graphs
from waveflow_tpu_torch.vmc.hmc import (
    dual_averaging, init_adaptation, value_and_grad,
)

DIVERGENCE_THRESHOLD = 1000.0


class NUTSState(NamedTuple):
    position: torch.Tensor      # (B, D) chains
    log_prob: torch.Tensor      # (B,)
    step_size: torch.Tensor     # ()
    # dual-averaging state (shared across chains)
    log_step_bar: torch.Tensor
    h_bar: torch.Tensor
    iteration: torch.Tensor
    mu: torch.Tensor            # anchor log(10 · ε₀)


class NUTSDraws(NamedTuple):
    """The random numbers of one step of B chains."""
    momentum: torch.Tensor      # (B, D) standard normals
    go_right: torch.Tensor      # (B, max_depth) bool: doubling j's direction
    leaf_u: torch.Tensor        # (B, 2^max_depth) uniforms: leaf i of
                                # doubling j at 2^j − 1 + i
    merge_u: torch.Tensor       # (B, max_depth) uniforms: doubling j's merge


class NUTSInfo(NamedTuple):
    depth: torch.Tensor         # (B,) doublings built
    n_leaves: torch.Tensor      # (B,) leaves built
    accept: torch.Tensor        # (B,) mean acceptance statistic of them


class _End(NamedTuple):
    """A point of the trajectory: position, momentum, gradient, log
    density."""
    z: torch.Tensor
    r: torch.Tensor
    g: torch.Tensor
    lp: torch.Tensor


def _is_turning(dz, r_a, r_b):
    return ((dz * r_a).sum(-1) < 0.0) | ((dz * r_b).sum(-1) < 0.0)


def draw(generator: torch.Generator, B: int, D: int, max_tree_depth: int,
         device) -> NUTSDraws:
    """One step's random numbers for B chains of dimension D."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)
    momentum = torch.randn((B, D), generator=generator, device=device)
    return NUTSDraws(momentum, u(B, max_tree_depth) < 0.5,
                     u(B, 2 ** max_tree_depth), u(B, max_tree_depth))


def _where(mask, a, b):
    return torch.where(mask.view(mask.shape + (1,) * (a.ndim - 1)), a, b)


def _column(x, j):
    """Column ``j`` (a 0-d device index) of ``x`` (B, n)."""
    return x.index_select(1, j.view(1))[:, 0]


class _Trajectory:
    """One NUTS step of the chains of ``state``'s shape, as bodies over
    static tensors written in place (the module's docstring).
    ``generator``: the start draws the step's numbers from it; None: the
    caller writes them into ``slots``."""

    def __init__(self, log_prob_fn, state: NUTSState, generator,
                 max_tree_depth: int, target_accept: float, axis_name):
        self.log_prob_fn, self.generator = log_prob_fn, generator
        self.M, self.target_accept = max_tree_depth, target_accept
        self.axis_name = axis_name
        B, D = state.position.shape
        M, dev = max_tree_depth, state.position.device

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def point():
            return _End(zeros(B, D), zeros(B, D), zeros(B, D), zeros(B))

        self.static = NUTSState(*(f.clone() for f in state))
        self.slots = NUTSDraws(zeros(B, D), zeros(B, M, dtype=torch.bool),
                               zeros(B, 2 ** M), zeros(B, M))
        # the trajectory: its two ends, its proposal, its sums
        self.plus, self.minus = point(), point()
        self.z_prop, self.lp_prop = zeros(B, D), zeros(B)
        self.h0, self.logw_sum = zeros(B), zeros(B)
        self.sum_alpha, self.n_alpha, self.accept = zeros(B), zeros(B), \
            zeros(B)
        self.depth = zeros(B, dtype=torch.int32)
        self.active = zeros(B, dtype=torch.bool)
        # the subtree: where it stands, its proposal, its sums, the
        # checkpoints of the leaves its blocks start at
        self.cur, self.step = point(), zeros(B, 1)
        self.sub_z_prop, self.sub_lp_prop = zeros(B, D), zeros(B)
        self.logw_sub, self.sub_alpha, self.sub_n = zeros(B), zeros(B), \
            zeros(B)
        self.live = zeros(B, dtype=torch.bool)
        self.sub_stop = zeros(B, dtype=torch.bool)
        self.ckpt_z, self.ckpt_r = zeros(M + 1, B, D), zeros(M + 1, B, D)
        # the indices and the flags the host reads
        self.i, self.j = (zeros(dtype=torch.int64) for _ in range(2))
        self.any_live, self.any_active = (zeros(dtype=torch.bool)
                                          for _ in range(2))
        # block sizes 2^k and their exponents k = 1 ... M; 2^k − 1 masks
        # the low k bits
        self.k = torch.arange(1, M + 1, device=dev)
        self.blocks = 2 ** self.k
        self.low_bits = self.blocks - 1

    def slot(self, x):
        """Checkpoint slot of leaf x (any shape of int64): the trailing
        zeros of x, the top slot M for x = 0 — the count of k ≤ M whose
        low k bits of x are all zero."""
        return ((x.unsqueeze(-1) & self.low_bits) == 0).sum(-1)

    @torch.no_grad()
    def start(self):
        """Draw the step (with a generator), the gradient at the chains,
        and every end of the trajectory at them."""
        s, d = self.static, self.slots
        if self.generator is not None:
            B, D = s.position.shape
            graphs.copy_into(d, draw(self.generator, B, D, self.M,
                                     s.position.device))
        z0, r0 = s.position, d.momentum
        lp0, g0 = value_and_grad(self.log_prob_fn, z0)
        self.h0.copy_(lp0 - 0.5 * (r0 * r0).sum(-1))
        for end in (self.plus, self.minus):
            graphs.copy_into(end, (z0, r0, g0, lp0))
        self.z_prop.copy_(z0)
        self.lp_prop.copy_(lp0)
        for x in (self.logw_sum, self.sum_alpha, self.n_alpha, self.depth,
                  self.j):           # the initial leaf: logw 0
            x.zero_()
        self.active.fill_(True)

    @torch.no_grad()
    def subtree(self):
        """Start doubling j from the end its direction picks."""
        right = _column(self.slots.go_right, self.j)
        graphs.copy_into(self.cur, [_where(right, a, b)
                                    for a, b in zip(self.plus, self.minus)])
        eps = self.static.step_size
        self.step.copy_(torch.where(right, eps, -eps)[:, None])
        self.live.copy_(self.active)          # building, not stopped
        self.sub_stop.zero_()
        self.sub_z_prop.copy_(self.cur.z)
        self.sub_lp_prop.copy_(self.cur.lp)
        self.logw_sub.fill_(-torch.inf)
        for x in (self.sub_alpha, self.sub_n, self.i):
            x.zero_()

    @torch.no_grad()
    def leaf(self):
        """Leaf i of doubling j, every chain in lockstep."""
        z, r, g, lp = self.cur
        step, live, i = self.step, self.live, self.i
        r_n = r + 0.5 * step * g
        z_n = z + step * r_n
        lp_n, g_n = value_and_grad(self.log_prob_fn, z_n)
        r_n = r_n + 0.5 * step * g_n
        # a NaN energy (a trajectory that left the target's domain) is a
        # divergence: JAX's NaN poisons the shared step size of every
        # chain for the rest of the run
        logw = torch.nan_to_num(lp_n - 0.5 * (r_n * r_n).sum(-1) - self.h0,
                                nan=-torch.inf)
        diverged = logw < -DIVERGENCE_THRESHOLD
        logw_sub_n = torch.logaddexp(self.logw_sub, logw)
        u = _column(self.slots.leaf_u, 2 ** self.j - 1 + i)
        take = live & (torch.log(u) < logw - logw_sub_n)
        self.sub_z_prop.copy_(_where(take, z_n, self.sub_z_prop))
        self.sub_lp_prop.copy_(torch.where(take, lp_n, self.sub_lp_prop))
        at = self.slot(i).view(1)
        self.ckpt_z.index_copy_(0, at, z_n[None])
        self.ckpt_r.index_copy_(0, at, r_n[None])
        # every block of 2^k ≤ 2^j leaves that ends at leaf i, against the
        # checkpoint of its start leaf (the others masked)
        ends = ((i + 1) % self.blocks == 0) & (self.k <= self.j)
        start = self.slot(torch.clamp(i + 1 - self.blocks, min=0))
        turning = (ends[:, None] & _is_turning(
            z_n - self.ckpt_z.index_select(0, start),
            self.ckpt_r.index_select(0, start), r_n)).any(0)
        alpha = torch.clamp(torch.exp(logw), max=1.0)
        graphs.copy_into(self.cur, [_where(live, a, b) for a, b in
                                    zip((z_n, r_n, g_n, lp_n), self.cur)])
        self.logw_sub.copy_(torch.where(live, logw_sub_n, self.logw_sub))
        self.sub_alpha.add_(torch.where(live, alpha, 0.0))
        self.sub_n.add_(live)
        stop = turning | diverged
        self.sub_stop.logical_or_(live & stop)
        live.logical_and_(~stop)
        self.any_live.copy_(live.any())
        i.add_(1)

    @torch.no_grad()
    def merge(self):
        """Merge doubling j's subtree into the trajectory."""
        right = _column(self.slots.go_right, self.j)
        active = self.active
        ok = active & ~self.sub_stop
        take = ok & (torch.log(_column(self.slots.merge_u, self.j))
                     < self.logw_sub - self.logw_sum)
        self.z_prop.copy_(_where(take, self.sub_z_prop, self.z_prop))
        self.lp_prop.copy_(torch.where(take, self.sub_lp_prop, self.lp_prop))
        self.logw_sum.copy_(torch.where(
            ok, torch.logaddexp(self.logw_sum, self.logw_sub),
            self.logw_sum))
        plus = [_where(ok & right, a, b) for a, b in zip(self.cur, self.plus)]
        minus = [_where(ok & ~right, a, b)
                 for a, b in zip(self.cur, self.minus)]
        graphs.copy_into(self.plus, plus)
        graphs.copy_into(self.minus, minus)
        turning_all = _is_turning(self.plus.z - self.minus.z, self.minus.r,
                                  self.plus.r)
        self.sum_alpha.copy_(torch.where(active, self.sum_alpha
                                         + self.sub_alpha, self.sum_alpha))
        self.n_alpha.copy_(torch.where(active, self.n_alpha + self.sub_n,
                                       self.n_alpha))
        self.depth.add_(active)
        active.logical_and_(~(self.sub_stop | turning_all))
        self.any_active.copy_(active.any())
        self.j.add_(1)

    def end(self, warmup: bool):
        @torch.no_grad()
        def body():
            """The proposal becomes the state; with ``warmup``, one
            dual-averaging update of the step size from the chains' mean
            acceptance statistic."""
            s = self.static
            self.accept.copy_(self.sum_alpha
                              / torch.clamp(self.n_alpha, min=1.0))
            s.position.copy_(self.z_prop)
            s.log_prob.copy_(self.lp_prop)
            if warmup:
                accept_prob = self.accept.mean()
                if self.axis_name is not None:
                    accept_prob = mesh.pmean(accept_prob, self.axis_name)
                graphs.copy_into(s, dual_averaging(s, accept_prob,
                                                   self.target_accept))
        return body

    def info(self) -> NUTSInfo:
        return NUTSInfo(self.depth.clone(), self.n_alpha.clone(),
                        self.accept.clone())


class _Steps:
    """A ``_Trajectory``'s bodies as windows, eagerly run or replayed
    (``graph``), and the host loop of a step over them.  The windows hold
    the trajectory and it holds none of them, so a dropped set is freed
    without the cyclic collector."""

    def __init__(self, t: _Trajectory, graph: bool):
        self.t = t
        gens = () if t.generator is None else (t.generator,)
        self.start = graphs.make_window(t.start, (), gens, graph)
        self.subtree, self.leaf, self.merge = (
            graphs.make_window(body, (), (), graph)
            for body in (t.subtree, t.leaf, t.merge))
        self.end = {warmup: graphs.make_window(t.end(warmup), (), (), graph)
                    for warmup in (True, False)}

    def __call__(self, warmup: bool) -> tuple:
        """One step: the bodies in the trajectory's order, ended on host
        reads.  Returns (leaves, host reads, body calls)."""
        t = self.t
        self.start()
        leaves = reads = 0
        for j in range(t.M):
            self.subtree()
            for i in range(2 ** j):
                self.leaf()
                leaves += 1
                if i + 1 < 2 ** j:
                    reads += 1
                    if not t.any_live:            # the host read
                        break
            self.merge()
            if j + 1 < t.M:
                reads += 1
                if not t.any_active:              # the host read
                    break
        self.end[warmup]()
        return leaves, reads, 2 + 2 * (j + 1) + leaves


def make_nuts_sampler(log_prob_fn: Callable, max_tree_depth: int = 8,
                      target_accept: float = 0.8, axis_name=None):
    """(init_fn, step_fn, run_fn) for NUTS on ``log_prob_fn(x (B, D)) ->
    (B,)``, with the contract of vmc/hmc.py:

    init_fn(position, step_size=0.1) -> NUTSState;
    step_fn(state, draws: NUTSDraws, warmup=False, return_info=False)
        -> NUTSState (and a NUTSInfo), eager;
    run_fn(state, generator, n_steps, n_warmup=0, return_info=False,
           graph=None)
        -> (state, trace (n_steps, B, D)) (and a dict of per-step figures:
        'depth' (steps, B), 'n_leaves' (steps, B), 'accept' (steps,), and
        the batch's 'leaves', 'host_reads' and 'calls' (body calls: replays
        on the graph path), (steps,) on the CPU); ``graph`` (default: on a
        CUDA device) replays the step's bodies as CUDA graphs, True on the
        CPU raises ValueError.

    ``axis_name``: the chain axis the batch is sharded over (the mean
    acceptance statistic averaged over it: one collective step size)."""
    if axis_name is not None:
        mesh.check_axis(axis_name)

    def steps(state, generator, graph: bool) -> _Steps:
        return _Steps(_Trajectory(log_prob_fn, state, generator,
                                  max_tree_depth, target_accept, axis_name),
                      graph)

    @torch.no_grad()
    def init_fn(position: torch.Tensor, step_size=0.1) -> NUTSState:
        eps0, log_bar, h_bar, it, mu = init_adaptation(step_size, position)
        return NUTSState(position, log_prob_fn(position), eps0, log_bar,
                         h_bar, it, mu)

    def step_fn(state: NUTSState, draws: NUTSDraws, warmup: bool = False,
                return_info: bool = False):
        """One NUTS transition of every chain from ``draws``; with
        ``warmup``, one dual-averaging update of the step size from the
        chains' mean acceptance statistic."""
        step = steps(state, None, False)
        graphs.copy_into(step.t.slots, draws)
        step(warmup)
        state = NUTSState(*(f.clone() for f in step.t.static))
        return (state, step.t.info()) if return_info else state

    captured = {}       # the graphed run's steps, for one key at a time

    def run_fn(state: NUTSState, generator: torch.Generator, n_steps: int,
               n_warmup: int = 0, return_info: bool = False,
               graph: bool | None = None):
        """``n_warmup`` adapting steps, then the step size set to exp(log ε̄)
        and ``n_steps`` kept steps; draws from ``generator``.  The graphed
        run's captures are kept for the next call at the same shape,
        device and generator, and dropped at the next call with another."""
        B, D = state.position.shape
        dev = state.position.device
        graph = graphs.use_graph(graph, dev)
        key = ((B, D), dev, generator)
        step = captured.get(key) if graph else None
        if step is None:
            step = steps(state, generator, graph)
            if graph:
                captured.clear()
                captured[key] = step
        t = step.t
        graphs.copy_into(t.static, state)
        n = n_warmup + n_steps
        trace = state.position.new_empty((n_steps, B, D))
        depth = torch.empty((n, B), dtype=torch.int32, device=dev)
        n_leaves, accept = (state.position.new_empty((n, B))
                            for _ in range(2))
        counts = []
        for s in range(n):
            counts.append(step(s < n_warmup))
            depth[s], n_leaves[s], accept[s] = t.depth, t.n_alpha, t.accept
            if s == n_warmup - 1:
                t.static.step_size.copy_(torch.exp(t.static.log_step_bar))
            if s >= n_warmup:
                trace[s - n_warmup] = t.static.position
        state = NUTSState(*(f.clone() for f in t.static))
        if return_info:
            leaves, reads, calls = torch.tensor(counts).reshape(n, 3).T
            return state, trace, {
                'depth': depth, 'n_leaves': n_leaves,
                'accept': accept.mean(1), 'leaves': leaves,
                'host_reads': reads, 'calls': calls}
        return state, trace

    return init_fn, step_fn, run_fn
