"""§6 load balancing as torch functions on ``[S, N]`` tensors, shared by the
engines (counterpart of ``repro.lb.jit_optimizer``).

Profiler window moments (§6.1), the gamma what-if draws and the batched
trace replay behind the contribution estimate ``h`` (§6.2), the equalize /
restore / slack hill-climb of Algorithm 1 on the p-ladder, the §6.3
publication gate, and the Algorithm-2 alignment walk.  The scalar
``TrainingSimulator`` calls them at ``S = 1``, the host engine and the
device engine on their ``[S]`` batches; all hill-climb state updates are
masked by per-scenario ``active`` flags, so inactive rows pass through.
The reference's ``while_loop``s are Python loops here: each checks
``any(active)`` and the round cap.

Every value is float64, and each one's bits depend only on its own row:
neither on how many scenarios share the call nor on the device.  That
takes three things:

* **Sums in one fixed order.**  A float64 ``torch.sum`` picks its
  reduction tree by shape and device.  :func:`ordered_sum` instead adds
  in the order XLA's CPU backend adds a ``jnp.sum`` along the last axis:
  one in-order fold up to 32 elements; past that, windows of 32 (the
  padding split evenly between the two ends), each folded in order, and
  then the window sums folded in order.  So the window moments and ``h``
  have the reference's bits on any device.
* **The reference's one contraction.**  XLA's CPU backend contracts the
  Wilson–Hilferty base ``1 − c + z·√c`` into a fused multiply-add.
  :func:`fma` rounds ``a·b + c`` once, exactly, from plain float64 ops
  (Dekker's product, then Boldo and Melquiond's round-to-odd sum), so it
  too is the same on the CPU and the card.  Every other expression is one
  eager torch op per operator, rounded once each, in the reference's
  left-to-right order.
* **Division by a tensor, and an exact square root.**  A CUDA tensor
  divided by a python number is multiplied by its reciprocal, so every
  division here has a tensor divisor, except the one the reference's
  compiled form itself turns into a multiplication by the reciprocal (the
  participation ``part / K``); torch's CPU ``sqrt`` can be an ulp off, so
  :func:`exact_sqrt` takes numpy's there.

The what-if replay runs in kernel K7 on the card (one launch per h
estimate) and in its plain version on the CPU (:mod:`repro_torch.kernels.
what_if`); the two are bit-equal.

Churn: ``window_moments`` takes the re-profiling cutoff ``since``, and
``estimate_h``, ``algorithm1``, ``should_publish`` and ``lb_update`` the
liveness mask ``alive`` (``[S, N]`` bool), as the reference does: dead
workers' what-if draws are +inf, the replay waits for ``w_eff = min(w,
#alive)`` per scenario, the max/argmax reductions and the publication gate
see the living fleet only, and dead workers keep their rung.  An all-True
mask takes the same float path as ``alive=None``.

The what-if draws: the reference draws one ``[N, K]`` standard-normal base
per component with ``jax.random.normal`` under the optimizer's seed.  Torch
cannot reproduce threefry, so the base is an input here, ``normals``
``[2, N, K]`` (comm, comp); :mod:`repro_torch.lb.optimizer` supplies it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import what_if

# Algorithm-1 constants shared by the optimizer defaults and the engines
H_TOLERANCE = 0.01
SIM_ITERATIONS = 100
MAX_ROUNDS = 200
IMPROVEMENT_THRESHOLD = 0.10
#: §6.1 moving-window width (seconds) of every engine's profiler view
PROFILER_WINDOW = 10.0

I64 = torch.int64
#: the window of XLA's CPU tree reduction (see :func:`ordered_sum`)
_SUM_WINDOW = 32


# ---------------------------------------------------------------------------
# Exact building blocks
# ---------------------------------------------------------------------------


def _fold(x):
    """Sum over the last axis, one add at a time, in index order."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for t in range(x.shape[-1]):
        acc = acc + x[..., t]
    return acc


def ordered_sum(x):
    """Sum over the last axis in the order of XLA's CPU reduction.

    Up to 32 elements: an in-order fold.  Past that: pad to a multiple of
    32 with zeros (the smaller half of the padding in front), fold each
    window of 32 in order, then sum the window sums the same way.  Adding
    the padding zeros changes no value.

    >>> ordered_sum(torch.arange(40, dtype=torch.float64)).item()
    780.0
    """
    L = x.shape[-1]
    if L <= _SUM_WINDOW:
        return _fold(x)
    nw = -(-L // _SUM_WINDOW)
    pad = nw * _SUM_WINDOW - L
    xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    windows = xp.reshape(x.shape[:-1] + (nw, _SUM_WINDOW))
    return ordered_sum(_fold(windows))


_SPLIT = 134217729.0  # 2^27 + 1: Veltkamp's splitter for 53-bit doubles


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """``a·b = p + e`` exactly (Dekker), with no fused multiply-add."""
    p = a * b
    ca = a * _SPLIT
    ah = ca - (ca - a)
    al = a - ah
    cb = b * _SPLIT
    bh = cb - (cb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _round_to_odd_sum(a, b):
    """``a + b`` rounded to odd: the nearest double toward the exact sum
    whose last significand bit is 1, unless the sum is exact."""
    s, err = _two_sum(a, b)
    even = (s.view(I64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s)


def fma(a, b, c):
    """``a·b + c`` rounded once (IEEE fused multiply-add), from float64 ops
    that round once each: Boldo and Melquiond's emulation (round the low
    parts to odd, then add to the high part).  Exact barring overflow and
    underflow of the partial products, on the CPU and the card alike."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _round_to_odd_sum(tl, ul)


def exact_sqrt(x):
    """Square root rounded once, as IEEE specifies: torch's CPU ``sqrt`` of
    a float64 tensor can be an ulp off (it is a vector-library
    approximation), so on the CPU numpy takes it; CUDA's is exact."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


# ---------------------------------------------------------------------------
# §6.1 — profiler window moments
# ---------------------------------------------------------------------------


def window_moments(t_rec, comm, comp, valid, now, window: float, since=None):
    """Moving-window mean and variance per worker (the §6.1 profiler view).

    ``t_rec``/``comm``/``comp``/``valid`` are ``[..., N, T]`` buffers indexed
    by the iteration that started the task; ``now`` is ``[...]`` per
    scenario.  A sample is in the window iff ``t_rec >= now - window``;
    ``since`` (``[...]``, optional) also drops samples recorded before it:
    the churn re-profiling cutoff, the latest fleet change (``-inf`` keeps
    every sample).  Returns ``(e_comm, v_comm, e_comp, v_comp, counts)``,
    the single-sample variance floored to 1e-12.
    """
    cutoff = (now - window)[..., None, None]
    if since is not None:
        cutoff = torch.maximum(cutoff, since[..., None, None])
    in_win = valid & (t_rec >= cutoff)
    cnt = in_win.sum(dim=-1)
    cnt_f = torch.clamp_min(cnt, 1).to(comm.dtype)

    def mean_var(x):
        mean = ordered_sum(torch.where(in_win, x, 0.0)) / cnt_f
        d = x - mean[..., None]
        var = ordered_sum(torch.where(in_win, d * d, 0.0)) / cnt_f
        return mean, torch.where(cnt > 1, var, 1e-12)

    e_comm, v_comm = mean_var(comm)
    e_comp, v_comp = mean_var(comp)
    return e_comm, v_comm, e_comp, v_comp, cnt


# ---------------------------------------------------------------------------
# §6.2 — objective and the h(p') contribution estimate
# ---------------------------------------------------------------------------


def e_total(e_comm, e_comp, p, p_new):
    """Linearised expected total latency e'_{X,i} (paper §6.2)."""
    return e_comm + e_comp * p / p_new


def objective(e_x):
    """max/min ratio of expected per-worker total latency (Eq. 7)."""
    lo = torch.clamp_min(e_x.amin(dim=-1), 1e-12)
    return e_x.amax(dim=-1) / lo


def _wilson_hilferty_gamma(z, shape, scale):
    """Gamma(shape, scale) draws from standard-normal draws ``z``: the
    Wilson–Hilferty cube transform shape·scale·(1 − c + z·√c)³ with
    c = 1/(9·shape), floored at 1e-12.  The base is one fused multiply-add
    (as the reference's compiled form) and the cube ``(y·y)·y``."""
    c = torch.ones_like(shape) / (9.0 * shape)
    y = fma(z, exact_sqrt(c), 1.0 - c)
    x = shape * scale * ((y * y) * y)
    return torch.clamp_min(x, 1e-12)


def _draw_what_if(normals, e_y, v_y, e_z, v_z):
    """``[S, N, K]`` what-if latency draws (comm, comp): the shared
    ``[N, K]`` normal bases pushed through the transform with each
    scenario's own moments, so a scenario's draws depend only on its own
    parameters."""
    z_comm, z_comp = normals[0], normals[1]
    comm = _wilson_hilferty_gamma(
        z_comm[None], ((e_y * e_y) / v_y)[:, :, None], (v_y / e_y)[:, :, None]
    )
    comp = _wilson_hilferty_gamma(
        z_comp[None], ((e_z * e_z) / v_z)[:, :, None], (v_z / e_z)[:, :, None]
    )
    return comm, comp


def estimate_h(e_comm, v_comm, e_comp, v_comp, n_j, p_cur, p_new, *, w: int,
               margin: float, normals, K: int = SIM_ITERATIONS,
               kernel_backend: str = "cuda", alive=None):
    """h(p') for every scenario via linearised what-if trace replay: the
    share of the data each worker is expected to contribute fresh per
    iteration, summed over workers (``[S]``).  ``kernel_backend="torch"``
    takes the replay's plain version on the card too.

    With ``alive``, dead workers' what-if comm draws are +inf: they never
    finish and contribute nothing, and the replay waits for ``w_eff =
    min(w, #alive)`` of the living fleet.  The denominator keeps the whole
    dataset: a death lowers h, the signal Algorithm 1 reacts to."""
    e_y = torch.clamp_min(e_comm, 1e-12)
    v_y = torch.clamp_min(v_comm, 1e-18)
    ratio = p_cur / p_new
    e_z = torch.clamp_min(e_comp * ratio, 1e-12)
    v_z = torch.clamp_min(v_comp * ratio * ratio, 1e-18)
    comm, comp = _draw_what_if(normals[:, :, :K], e_y, v_y, e_z, v_z)
    w_arg = w
    if alive is not None:
        comm = torch.where(alive[:, :, None], comm, torch.inf)
        w_arg = torch.clamp_max(alive.sum(dim=1), w)
    # the replay: kernel K7 on the card, its plain version on the CPU (the
    # tasks' comp + comm added once for every draw, as task_finish_time adds)
    replay = (what_if.what_if_replay if kernel_backend == "cuda"
              else what_if.what_if_replay_plain)
    u = replay(comp + comm, w_arg, margin)
    n_tot = ordered_sum(n_j)
    return ordered_sum(u * n_j / (p_new * n_tot[:, None]))


# ---------------------------------------------------------------------------
# The p-ladder view
# ---------------------------------------------------------------------------


def ladder_tables(ladder: tuple[int, ...], n_j):
    """``(eff [.., N, L], idx_cap [.., N])``: ``eff[.., i, l] = min(ladder[l],
    n_j[.., i])``, strictly increasing up to ``idx_cap`` (the last index
    before the ladder saturates at the worker's sample count)."""
    raw = torch.tensor(ladder, dtype=n_j.dtype, device=n_j.device)
    eff = torch.minimum(raw, n_j[..., None])
    idx_cap = torch.clamp_max((raw < n_j[..., None]).sum(dim=-1), len(ladder) - 1)
    return eff, idx_cap


def ladder_value(eff, idx):
    """``eff[.., i, idx[.., i]]``: the p value at each worker's ladder index."""
    return eff.gather(-1, idx[..., None])[..., 0]


def snap_to_ladder(eff, idx_cap, v):
    """Index of the largest ladder value <= v (clipped into [0, idx_cap])."""
    cnt = (eff <= v[..., None]).sum(dim=-1)
    return torch.minimum(torch.clamp_min(cnt - 1, 0), idx_cap)


def _add_at(idx, rows, cols, delta):
    out = idx.clone()
    out[rows, cols] += delta
    return out


# ---------------------------------------------------------------------------
# Algorithm 1 on the ladder
# ---------------------------------------------------------------------------


def algorithm1(p_cur, e_comm, v_comm, e_comp, v_comp, n_j, h_min, active, *,
               ladder: tuple[int, ...], w: int, margin: float, normals,
               K: int = SIM_ITERATIONS, h_tol: float = H_TOLERANCE,
               max_rounds: int = MAX_ROUNDS, kernel_backend: str = "cuda",
               alive=None):
    """Equalize / restore contribution / spend slack (paper Algorithm 1).

    All tensors are ``[S, N]`` float64 (``h_min`` ``[S]`` float64,
    ``active`` ``[S]`` bool); rows with ``active`` False pass through.
    Returns ``(idx_new, p_new, h_min, last_h)``: ladder indices, their
    float values, the contribution floor, and h at the returned vector.
    ``alive`` (``[S, N]`` bool) restricts the hill-climb to the living
    fleet: dead workers are left out of the equalize target and the
    restore/slack picks, keep their current rung, and never finish in the
    what-if replay.
    """
    S, N = p_cur.shape
    rows = torch.arange(S, device=p_cur.device)
    eff, idx_cap = ladder_tables(ladder, n_j)

    def h_of(p_new):
        return estimate_h(e_comm, v_comm, e_comp, v_comp, n_j, p_cur, p_new,
                          w=w, margin=margin, normals=normals, K=K,
                          kernel_backend=kernel_backend, alive=alive)

    def only_alive(x):  # the living fleet, for the max/argmax reductions
        return x if alive is None else torch.where(alive, x, -torch.inf)

    # h_min = h(p_0) where not yet established (NaN)
    unset = torch.isnan(h_min) & active
    if bool(unset.any()):
        h_min = torch.where(unset, h_of(p_cur), h_min)

    # --- equalize total latency against the slowest worker ---
    e_x = e_total(e_comm, e_comp, p_cur, p_cur)
    slowest = torch.argmax(only_alive(e_x), dim=1)
    p_s = p_cur[rows, slowest]
    target = e_comm[rows, slowest] + e_comp[rows, slowest] * p_s / p_s
    denom = target[:, None] - e_comm
    safe = torch.where(denom > 0, denom, 1.0)
    balanced = torch.clamp_min(torch.floor(e_comp * p_cur / safe), 1.0)
    # comm-bound workers (denom <= 0) get the ladder's least-work rung
    cand = torch.where(denom <= 0, ladder_value(eff, idx_cap), balanced)
    cand = torch.minimum(torch.clamp_min(cand, 1.0), n_j)
    idx = snap_to_ladder(eff, idx_cap, cand)
    if alive is not None:  # dead workers keep their current rung
        idx = torch.where(alive, idx, snap_to_ladder(eff, idx_cap, p_cur))
    h = h_of(ladder_value(eff, idx))

    # --- restore contribution: give the fastest workers more work ---
    act = active & (h < h_min * (1.0 - h_tol))
    r = 0
    while r < max_rounds and bool(act.any()):
        e_now = e_total(e_comm, e_comp, p_cur, ladder_value(eff, idx))
        valid = idx > 0  # one rung down = strictly more work per task
        if alive is not None:
            valid = valid & alive
        order = torch.argsort(e_now, dim=1, stable=True)
        valid_ord = valid.gather(1, order)
        movable = valid_ord.any(dim=1)
        pick = order[rows, torch.argmax(valid_ord.to(torch.int8), dim=1)]
        act = act & movable
        idx = _add_at(idx, rows, pick, torch.where(act, -1, 0))
        h = torch.where(act, h_of(ladder_value(eff, idx)), h)
        act = act & (h < h_min * (1.0 - h_tol))
        r += 1

    # --- spend slack: reduce the slowest workers' load while h holds ---
    act = active & (h >= 0.99 * h_min)
    r = 0
    while r < max_rounds and bool(act.any()):
        e_now = e_total(e_comm, e_comp, p_cur, ladder_value(eff, idx))
        slowest = torch.argmax(only_alive(e_now), dim=1)
        act = act & (idx[rows, slowest] < idx_cap[rows, slowest])
        prev_idx, prev_h = idx, h
        idx = _add_at(idx, rows, slowest, torch.where(act, 1, 0))
        h = torch.where(act, h_of(ladder_value(eff, idx)), h)
        viol = act & (h < 0.99 * h_min)
        # back out the violating step, and its h with it
        idx = torch.where(viol[:, None], prev_idx, idx)
        h = torch.where(viol, prev_h, h)
        act = act & ~viol
        r += 1
    return idx, ladder_value(eff, idx), h_min, h


def should_publish(p_cur, p_new, e_comm, e_comp, threshold: float, alive=None):
    """``[S]`` bool: the Eq.-(7) objective improves by more than
    ``threshold`` (paper §6.3).  With ``alive``, the max/min latency ratio
    is taken over the living fleet only."""

    def ratio(e_x):
        if alive is None:
            return objective(e_x)
        hi = torch.where(alive, e_x, -torch.inf).amax(dim=-1)
        lo = torch.where(alive, e_x, torch.inf).amin(dim=-1)
        return hi / torch.clamp_min(lo, 1e-12)

    cur = ratio(e_total(e_comm, e_comp, p_cur, p_cur))
    new = ratio(e_total(e_comm, e_comp, p_cur, p_new))
    return new < cur * (1.0 - threshold)


def lb_update(p_cur, e_comm, v_comm, e_comp, v_comp, n_j, h_min, active, *,
              ladder: tuple[int, ...], w: int, margin: float, normals,
              K: int = SIM_ITERATIONS, h_tol: float = H_TOLERANCE,
              max_rounds: int = MAX_ROUNDS, threshold: float = IMPROVEMENT_THRESHOLD,
              kernel_backend: str = "cuda", alive=None):
    """One §6 optimizer round: Algorithm 1, then the publication gate.

    Returns ``(p_new [S, N] int64, h_min [S], last_h [S], publish [S])``,
    ``h_min`` updated for active rows only and ``publish`` False for
    inactive ones.  ``alive`` masks as in :func:`algorithm1`; dead workers'
    published p is their current p.
    """
    _, p_new_f, h_min_out, last_h = algorithm1(
        p_cur, e_comm, v_comm, e_comp, v_comp, n_j, h_min, active,
        ladder=ladder, w=w, margin=margin, normals=normals, K=K, h_tol=h_tol,
        max_rounds=max_rounds, kernel_backend=kernel_backend, alive=alive,
    )
    h_min_out = torch.where(active, h_min_out, h_min)
    pub = should_publish(p_cur, p_new_f, e_comm, e_comp, threshold, alive=alive) & active
    p_out = torch.clamp_min(p_new_f, 1.0).to(I64)
    p_out = torch.where(active[:, None], p_out, p_cur.to(I64))
    if alive is not None:
        p_out = torch.where(alive, p_out, p_cur.to(I64))
    return p_out, h_min_out, last_h, pub


# ---------------------------------------------------------------------------
# Algorithm 2 — the alignment walk on integer tensors
# ---------------------------------------------------------------------------


def _p_start_j(n, p, i):
    return (i - 1) * n // p + 1


def _p_trans_j(n, p, p_new, k):
    s = _p_start_j(n, p, k) * p_new
    return (s + n - 1) // n  # ceil for positive ints


def align_batch(n, p, p_new, k, needs):
    """The Algorithm-2 walk (``partitioner._align``) on int64 tensors;
    entries with ``needs`` False come back unchanged.  Integer arithmetic
    only, so the result is the scalar walk's."""
    n = torch.broadcast_to(n, k.shape)
    one = torch.ones_like(k)
    k_new = torch.where(needs, _p_trans_j(n, p, p_new, k), k)

    def aligned(kk, kn):
        return _p_start_j(n, p_new, kn) == _p_start_j(n, p, kk)

    done = (~needs) | aligned(k, k_new)
    while not bool(done.all()):
        kn2 = torch.where(done, k_new, k_new - 1)
        fb = (~done) & (kn2 < 1)  # the always-aligned (1, 1) fallback
        k = torch.where(fb, one, torch.where(done, k, _p_trans_j(n, p_new, p, kn2)))
        k_new = torch.where(fb, one, kn2)
        done = done | fb | aligned(k, k_new)
    return k, k_new
