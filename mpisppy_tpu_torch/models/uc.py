"""UC — stochastic unit commitment (port of `mpisppy_tpu/models/uc.py`).

G thermal units, H hours.  First stage: commitment u_gh in {0,1} and
startup s_gh >= 0.  Second stage, per wind scenario w: dispatch
p_gh >= 0 and load shed sh_h >= 0:

    p_gh <= Pmax_g * u_gh ;  p_gh >= Pmin_g * u_gh
    sum_g p_gh + wind^s_h + sh_h >= demand_h        (balance)
    s_gh >= u_gh - u_g,h-1                          (startup def)
    |p_gh - p_g,h-1| <= ramp_g                      (ramping)
    u_g,tau >= u_gh - u_g,h-1   for tau in (h, h+UT_g)   (min up)
    u_g,tau <= 1 - (u_g,h-1 - u_gh) for tau in (h, h+DT_g)  (min down)
    min sum_gh (cNL_g u_gh + cSU_g s_gh) +
        E[ sum_gh cV_g p_gh + pen * sum_h sh_h ]

Nonants: u, s (first stage).  `build_batch` works in numpy up to the
final wrap into tensors, so its arrays equal the JAX package's exactly.
With shared_A (the default) the constraint matrix is stored once,
(1, M, N): UC's uncertainty lives in the balance-row bounds only.  Full
width is fleet_multiplier=7 (21 units) and H=24: M=2502, N=1536.

The commitment-recovery helpers (`commitment_candidates`,
`one_opt_commitment`) screen candidates through
`SPOpt.evaluate_candidates` and certify with `evaluate_xhat`.

Not ported yet (ROADMAP queue A item 12): `scenario_block`,
`scenario_source` and `export_corpus`, which need the streaming layer.
"""

from __future__ import annotations

import numpy as np

import torch

from .. import not_ported
from ..convert import batch_from_arrays

INF = float("inf")

# fleet: Pmin, Pmax, ramp, cNL (no-load), cSU (startup), cV (variable)
_FLEET = np.array([
    # Pmin  Pmax  ramp  cNL   cSU    cV
    [100.0, 400.0, 150.0, 500.0, 800.0, 15.0],    # big coal-ish
    [50.0, 200.0, 100.0, 300.0, 400.0, 25.0],     # mid gas
    [10.0, 100.0, 100.0, 100.0, 100.0, 40.0],     # peaker
])
# min-up / min-down hours per base unit (big units cycle slowly)
_UT = np.array([3, 2, 1])
_DT = np.array([3, 2, 1])
_PEN = 1000.0


def demand_profile(H):
    hours = np.arange(H)
    return 350.0 + 150.0 * np.sin(np.pi * (hours + 2) / (H / 1.5))


def wind_profile(scennum, H, seed=91):
    rng = np.random.RandomState(seed + 17 * scennum)
    base = 80.0 + 60.0 * rng.rand()
    wiggle = 40.0 * rng.rand(H)
    return np.maximum(0.0, base + wiggle - 20.0)


def build_batch(num_scens, H=6, n_units=None, seed=91,
                fleet_multiplier=1, dtype=np.float64, shared_A=True,
                min_up_down=False, reserve_factor=0.0, scens=None,
                device=None):
    """fleet_multiplier k replicates the 3-unit fleet k times with
    seeded parameter jitter and scales demand to match — the scaling
    axis of the reference's larger_uc instances (paperruns/larger_uc:
    3..1000 wind scenarios on bigger systems).

    shared_A (default True): UC's uncertainty lives entirely in the
    balance-row BOUNDS (wind offsets demand) — the constraint matrix is
    scenario-independent.  Storing it once, (1, M, N), turns every
    batched matvec into one (S, N) x (N, M) matrix product (ir.bmatvec)
    and cuts the constraint-tensor memory by S.

    reserve_factor r > 0 adds the egret-style spinning-reserve rows
    (one per hour), in capacity-adequacy form: committed capacity
    sum_g Pmax_g u_gh must cover net load plus r * demand_h.  Neither
    dispatch nor load shed appears in the row, so shedding cannot
    satisfy reserve — an under-committed hour is infeasible, not
    merely expensive — which is what makes reserve bind the
    commitment the way the reference's egret UC reserves do.  Wind
    enters the row bound per scenario (like the balance rows), so
    shared_A is preserved.

    scens: optional GLOBAL scenario index set; default the contiguous
    universe [0, num_scens).  Scenario i's wind depends only on i
    (wind_profile seeds RandomState(seed + 17*i)), so an arbitrary
    index set yields exactly those scenarios' data.

    device: where the batch's tensors live (default: the CUDA
    device)."""
    if reserve_factor < 0:
        raise ValueError(
            f"reserve_factor must be >= 0, got {reserve_factor}")
    scens = (np.arange(num_scens, dtype=np.int64) if scens is None
             else np.asarray(scens, dtype=np.int64))
    fleet = _FLEET if n_units is None else _FLEET[:n_units]
    if fleet_multiplier > 1:
        rng = np.random.RandomState(seed + 5)
        reps = []
        for k in range(fleet_multiplier):
            jit = 1.0 + 0.1 * (rng.rand(len(fleet), 6) - 0.5)
            reps.append(fleet * jit)
        fleet = np.concatenate(reps, axis=0)
    G = len(fleet)
    S = scens.size
    Pmin, Pmax, ramp, cNL, cSU, cV = fleet.T

    # layout: [u (G*H) | s (G*H) | p (G*H) | sh (H)], unit-major blocks
    iu, isu, ip, ish = 0, G * H, 2 * G * H, 3 * G * H
    N = 3 * G * H + H

    def uidx(g, h):
        return iu + g * H + h

    def sidx(g, h):
        return isu + g * H + h

    def pidx(g, h):
        return ip + g * H + h

    # min-up/min-down windows per unit: tile the base table to however
    # many units the fleet actually has (n_units trims the base fleet,
    # fleet_multiplier replicates it — both change G).  These tables
    # are also stored on the batch (model_meta) so candidate repair
    # uses EXACTLY what A encodes, never a re-derivation.
    nb = min(len(_FLEET) if n_units is None else n_units, len(_FLEET))
    ut = np.tile(_UT[:nb], (G + nb - 1) // nb)[:G]
    dt_ = np.tile(_DT[:nb], (G + nb - 1) // nb)[:G]
    mud_rows = []
    if min_up_down:
        for g in range(G):
            for h in range(1, H):
                for tau in range(h + 1, min(h + int(ut[g]), H)):
                    mud_rows.append(("up", g, h, tau))
                for tau in range(h + 1, min(h + int(dt_[g]), H)):
                    mud_rows.append(("dn", g, h, tau))

    # rows: pmax (GH), pmin (GH), balance (H), startup (GH),
    # ramp up (G(H-1)), ramp down (G(H-1)), min up/down windows,
    # spinning reserve (H, if reserve_factor > 0)
    n_res = H if reserve_factor > 0 else 0
    M = 3 * G * H + H + 2 * G * (H - 1) + len(mud_rows) + n_res
    SA = 1 if shared_A else S   # matrix is scenario-independent
    A = np.zeros((SA, M, N), dtype=dtype)
    row_lo = np.full((S, M), -INF, dtype=dtype)
    row_hi = np.full((S, M), INF, dtype=dtype)
    r = 0
    for g in range(G):
        for h in range(H):
            A[:, r, pidx(g, h)] = 1.0      # p - Pmax u <= 0
            A[:, r, uidx(g, h)] = -Pmax[g]
            row_hi[:, r] = 0.0
            r += 1
    for g in range(G):
        for h in range(H):
            A[:, r, pidx(g, h)] = 1.0      # p - Pmin u >= 0
            A[:, r, uidx(g, h)] = -Pmin[g]
            row_lo[:, r] = 0.0
            r += 1
    dem = demand_profile(H) * fleet_multiplier
    wind = np.stack([wind_profile(int(s), H, seed)
                     for s in scens]) * fleet_multiplier
    for h in range(H):                     # balance
        for g in range(G):
            A[:, r, pidx(g, h)] = 1.0
        A[:, r, ish + h] = 1.0
        row_lo[:, r] = dem[h] - wind[:, h]
        r += 1
    for g in range(G):                     # s_gh >= u_gh - u_g,h-1
        for h in range(H):
            A[:, r, sidx(g, h)] = 1.0
            A[:, r, uidx(g, h)] = -1.0
            if h > 0:
                A[:, r, uidx(g, h - 1)] = 1.0
            row_lo[:, r] = 0.0
            r += 1
    for g in range(G):                     # ramping
        for h in range(1, H):
            A[:, r, pidx(g, h)] = 1.0
            A[:, r, pidx(g, h - 1)] = -1.0
            row_hi[:, r] = ramp[g]
            r += 1
    for g in range(G):
        for h in range(1, H):
            A[:, r, pidx(g, h)] = -1.0
            A[:, r, pidx(g, h - 1)] = 1.0
            row_hi[:, r] = ramp[g]
            r += 1
    # min-up: u_tau >= u_h - u_{h-1}  ->  u_h - u_{h-1} - u_tau <= 0
    # min-down: (u_{h-1} - u_h) + u_tau <= 1
    for kind, g, h, tau in mud_rows:
        if kind == "up":
            A[:, r, uidx(g, h)] = 1.0
            A[:, r, uidx(g, h - 1)] = -1.0
            A[:, r, uidx(g, tau)] = -1.0
            row_hi[:, r] = 0.0
        else:
            A[:, r, uidx(g, h - 1)] = 1.0
            A[:, r, uidx(g, h)] = -1.0
            A[:, r, uidx(g, tau)] = 1.0
            row_hi[:, r] = 1.0
        r += 1
    # spinning reserve, capacity-adequacy form: committed capacity
    # sum_g Pmax_g u_gh >= net load + r * demand.  Neither p nor shed
    # appears in the row — a headroom form (sum Pmax u - p >= R) leaks
    # through shedding, because raising shed lets p drop and frees
    # headroom one-for-one; the capacity form is what actually forces
    # commitment.  Wind sits in the row BOUND, per scenario, exactly
    # like the balance rows — shared_A is preserved.
    if n_res:
        for h in range(H):
            for g in range(G):
                A[:, r, uidx(g, h)] = Pmax[g]
            row_lo[:, r] = (dem[h] - wind[:, h]
                            + reserve_factor * dem[h])
            r += 1
    assert r == M

    lb = np.zeros((S, N), dtype=dtype)
    # implied finite boxes (farmer-style, provably inactive at some
    # optimum): p <= Pmax follows from the forcing row with u <= 1;
    # shedding beyond demand is pure cost.  All-finite boxes make the
    # PDHG dual objective a valid Lagrangian bound at ANY iterate
    # (spopt.valid_Ebound), so Lagrangian spokes need no certificates.
    ub = np.full((S, N), INF, dtype=dtype)
    ub[:, iu:isu] = 1.0
    ub[:, isu:ip] = 1.0
    for g in range(G):
        ub[:, ip + g * H: ip + (g + 1) * H] = Pmax[g]
    ub[:, ish:] = 2.0 * dem.max()

    c = np.zeros((S, N), dtype=dtype)
    for g in range(G):
        c[:, iu + g * H: iu + (g + 1) * H] = cNL[g]
        c[:, isu + g * H: isu + (g + 1) * H] = cSU[g]
        c[:, ip + g * H: ip + (g + 1) * H] = cV[g]
    c[:, ish:] = _PEN

    integer_mask = np.zeros((S, N), dtype=bool)
    integer_mask[:, iu:isu] = True

    stage_cost_c = np.zeros((2, S, N), dtype=dtype)
    stage_cost_c[0, :, : 2 * G * H] = c[:, : 2 * G * H]
    stage_cost_c[1, :, 2 * G * H:] = c[:, 2 * G * H:]

    nonant_idx = np.arange(2 * G * H, dtype=np.int32)
    var_names = (
        tuple(f"u[{g},{h}]" for g in range(G) for h in range(H))
        + tuple(f"su[{g},{h}]" for g in range(G) for h in range(H))
        + tuple(f"p[{g},{h}]" for g in range(G) for h in range(H))
        + tuple(f"shed[{h}]" for h in range(H)))
    tree = dict(
        node_of=np.zeros((S, 2 * G * H), np.int32),
        prob=np.full((S,), 1.0 / S, dtype=dtype),
        num_nodes=1,
        stage_of=(1,) * (2 * G * H),
        nonant_names=var_names[: 2 * G * H],
        scen_names=tuple(f"Scenario{int(i)+1}" for i in scens),
    )
    return batch_from_arrays(dict(
        c=c, qdiag=np.zeros((S, N), dtype=dtype),
        A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        obj_const=np.zeros((S,), dtype=dtype),
        nonant_idx=nonant_idx, integer_mask=integer_mask,
        tree=tree, stage_cost_c=stage_cost_c, var_names=var_names,
        model_meta={"uc_H": H, "uc_G": G,
                    "uc_ut": ut, "uc_dt": dt_,
                    "uc_min_up_down": bool(min_up_down),
                    "uc_reserve_factor": float(reserve_factor)}),
        device=device)


def scenario_block(indices, num_scens=None, **kwargs):
    raise not_ported("uc.scenario_block (the streaming block contract)",
                     12)


def scenario_source(num_scens, cfg=None):
    raise not_ported("uc.scenario_source (streaming.ScenarioSource)", 12)


def export_corpus(path, num_scens, shard_width=64, cfg=None):
    raise not_ported("uc.export_corpus (streaming/store.py)", 12)


def scenario_names_creator(num_scens, start=0):
    return [f"Scenario{i+1}" for i in range(start, start + num_scens)]


def repair_min_up_down(u, ut, dt_, H):
    """Repair a (G*H,) rounded commitment to honor per-unit min-up/
    min-down windows: every on-run is extended forward to >= UT hours,
    then every off-run to >= DT hours (extension over-commits — the
    cheap direction; shedding at the penalty price is the expensive
    one).  Idempotent on window-feasible commitments."""
    u = np.asarray(u, float).copy()
    G = u.size // H
    for g in range(G):
        blk = u[g * H:(g + 1) * H]
        # extend on-runs to UT
        h = 0
        while h < H:
            if blk[h] == 1.0 and (h == 0 or blk[h - 1] == 0.0):
                run = 0
                while h + run < H and blk[h + run] == 1.0:
                    run += 1
                need = int(ut[g]) - run
                for k in range(h + run, min(h + run + max(need, 0), H)):
                    blk[k] = 1.0
                h += max(run, 1)
            else:
                h += 1
        # merge off-runs shorter than DT (turn them on)
        h = 0
        while h < H:
            if blk[h] == 0.0 and h > 0 and blk[h - 1] == 1.0:
                run = 0
                while h + run < H and blk[h + run] == 0.0:
                    run += 1
                ends_inside = h + run < H      # off-run then back on
                if ends_inside and run < int(dt_[g]):
                    blk[h:h + run] = 1.0
                h += max(run, 1)
            else:
                h += 1
        u[g * H:(g + 1) * H] = blk
    return u


def commitment_candidate(batch, xbar_row, threshold=0.5):
    """Integer-feasible first-stage candidate from a consensus vector:
    commit unit-hours whose consensus weight exceeds `threshold`, then
    DERIVE the startup s from the rounded u (s_h = max(0,
    u_h - u_{h-1})) — fixing s at its averaged value alongside a
    rounded u violates the startup-definition rows whenever rounding
    flips a commitment.

    Round-to-nearest (threshold 0.5) is usually terrible for UC: a
    0.4-committed unit rounds OFF and its lost capacity is bought back
    as load shedding at the penalty price.  Thresholds below 0.5
    over-commit (cost: no-load + startup) instead of shedding; use
    `commitment_candidates` to screen several thresholds in one
    batched evaluation."""
    vals = _host(xbar_row).copy()
    K = vals.size
    GH = K // 2
    u = (np.clip(vals[:GH], 0, 1) > threshold).astype(float)
    # when the batch carries min-up/min-down rows, a bare rounding is
    # usually window-infeasible; repair by extending runs (over-commit
    # — the cheap direction vs shedding).  The window tables come from
    # the batch's own metadata, i.e. exactly what A encodes.
    meta = batch.model_meta or {}
    if meta.get("uc_min_up_down"):
        u = repair_min_up_down(u, np.asarray(meta["uc_ut"]),
                               np.asarray(meta["uc_dt"]),
                               int(meta["uc_H"]))
    return np.concatenate([u, _derive_startups(batch, u)])


def commitment_candidates(batch, xbar_row,
                          thresholds=(0.02, 0.1, 0.25, 0.5, 0.75)):
    """(k, K) stack of threshold-commitment candidates — feed to
    SPOpt.evaluate_candidates for one-launch speculative screening
    (SURVEY.md §2.10)."""
    return np.stack([commitment_candidate(batch, xbar_row, t)
                     for t in thresholds])


def _host(a):
    """A float64 numpy copy of a vector given as a tensor (on any
    device) or an array-like."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.array(a, dtype=float)


def _derive_startups(batch, u):
    GH = u.size
    H = _infer_H(batch, GH)
    G = GH // H
    s = np.zeros_like(u)
    for g in range(G):
        blk = slice(g * H, (g + 1) * H)
        ub_ = u[blk]
        s[blk][0] = ub_[0]
        s[blk][1:] = np.maximum(0.0, ub_[1:] - ub_[:-1])
    return s


def one_opt_commitment(evaluator, batch, candidate, max_sweeps=4,
                       flip_slots=None, chunk=64, screen_eps=None,
                       screen_cap=None, verify_k=3):
    """Batched 1-opt local search on the commitment: each sweep
    evaluates single unit-hour flips of the incumbent commitment in
    stacked launches (up to `chunk` candidates x S scenarios each,
    SPOpt.evaluate_candidates) and keeps the best improving flip.
    Returns (candidate, value).  This is how the reference's slam/xhat
    heuristics earn UC incumbents near the MIP optimum without a MIP
    solver in the loop.

    flip_slots: restrict the search to these u-slot indices (the
    default sweeps ALL slots — measured at S=50 vs a MIP oracle, the
    wrongly-committed slots are usually NOT the fractional-consensus
    ones, so restricted sweeps stall at the threshold incumbent).

    chunk: flips per stacked launch.  A reference-scale fleet has
    GH ~ 500 slots; one (GH*S)-scenario stack of the (1536-var,
    2500-row) subproblem arrays would run to tens of GB, so sweeps
    launch bounded chunks instead.

    screen_eps / screen_cap: when either is set, sweep launches run
    as a cheap RANKING pass (loose tolerance, bounded PDHG
    iterations) and flips are certified in screened rank order with
    the accurate evaluator, keeping the first genuinely improving one
    — the same two-stage screen/verify protocol as opt/mip.py's
    refinement.  Per sweep at most `verify_k` ranks are certified
    (3*verify_k on a would-be-terminating FULL sweep), so the
    termination criterion under screening is "no flip among the top
    3*verify_k screened ranks of a full sweep improves" — a bounded
    relaxation of the exhaustive criterion, traded for ~10x cheaper
    launches.  Screening also enables full/restricted sweep
    alternation: a FULL sweep ranks every slot (len/chunk launches);
    later sweeps re-rank only the top-`chunk` hot slots (1 launch),
    and any stall triggers a full refresh, so only a full sweep can
    terminate the search.  At reference scale (504 slots x 8 sweeps
    x S=1000) full-accuracy sweeps are ~64 launches of a
    64k-scenario stack; screening is what makes the full-slot search
    affordable on one chip.  Without screen_*, behavior is the
    original exhaustive protocol: every sweep scans all flip_slots
    at full accuracy and only the argmin flip is certified."""
    cand = _host(candidate).copy()
    GH = cand.size // 2
    if flip_slots is None:
        flip_slots = np.arange(GH)
    flip_slots = np.asarray(flip_slots, int)
    screening = screen_eps is not None or screen_cap is not None
    if screening and screen_eps is None:
        # cap-only screening: a capped solve can't reach the
        # full-accuracy tolerance, so derive a loose one from the
        # evaluator's eps instead of screening everything infeasible
        screen_eps = 10 * float(np.asarray(evaluator.solver_eps))
    # a capped/loose screen can't reach the full-accuracy residual
    # tolerance — widen the feasibility screen; certify restores rigor
    screen_tol = 10 * float(screen_eps) if screening else None
    # every launch is padded to one canonical candidate count, so the
    # evaluator's one-live-stack cache and the jit shape survive
    # across chunks, sweeps, and full/restricted alternation
    kfix = min(chunk, len(flip_slots)) or 1
    val, feas = evaluator.evaluate_xhat(cand)
    if not feas:
        return cand, np.inf
    hot_slots = None
    # a failed RESTRICTED sweep schedules a full-sweep refresh; that
    # refresh runs outside the max_sweeps budget, so the search always
    # ends on a terminating full sweep (accept -> budget resumes;
    # reject -> break), never on a stalled restricted sweep — the
    # documented termination criterion even at small max_sweeps
    sweeps_done = 0
    pending_refresh = False
    while sweeps_done < max_sweeps or pending_refresh:
        if pending_refresh:
            pending_refresh = False
        else:
            sweeps_done += 1
        full = hot_slots is None
        slots = flip_slots if full else hot_slots
        flips = []
        for j in slots:
            u = cand[:GH].copy()
            u[j] = 1.0 - u[j]
            flips.append(np.concatenate([u, _derive_startups(batch, u)]))
        if not flips:
            break
        objs = np.empty(len(flips))
        feas_m = np.zeros(len(flips), bool)
        for lo in range(0, len(flips), kfix):
            sl = slice(lo, min(lo + kfix, len(flips)))
            block = flips[sl]
            k = len(block)
            if k < kfix:
                block = block + [cand] * (kfix - k)
            o, f = evaluator.evaluate_candidates(
                np.stack(block), eps=screen_eps, iters_cap=screen_cap,
                tol=screen_tol)
            objs[sl], feas_m[sl] = o[:k], f[:k]
        ok = np.flatnonzero(feas_m)
        if full and screening and len(flip_slots) > chunk:
            # hot set = best-ranked feasible slots; spuriously-
            # infeasible ones (screen stragglers) fill the tail so
            # restricted sweeps can still revisit them.  (When all
            # slots fit one launch, a "restricted" sweep would be the
            # same launch — stay in all-full mode.)
            bad = np.setdiff1d(np.arange(len(flips)), ok)
            order_all = np.concatenate([ok[np.argsort(objs[ok])], bad])
            hot_slots = np.asarray(slots)[order_all[:chunk]]
        if ok.size == 0:
            if full:
                break
            hot_slots = None
            pending_refresh = True
            continue
        # certify candidates in screened rank order with the accurate
        # evaluator; keep the first genuine improvement.  A full sweep
        # about to terminate digs deeper (3x) before giving up.
        order = ok[np.argsort(objs[ok])]
        if screening:
            tries = order[:(3 * verify_k if full else verify_k)]
        else:
            tries = order[:1]
        accepted = False
        for j in map(int, tries):
            v2, f2 = evaluator.evaluate_xhat(flips[j])
            if f2 and v2 < val - 1e-7 * (1 + abs(val)):
                cand, val = flips[j], v2
                accepted = True
                break
        if not accepted:
            if full:
                break
            hot_slots = None   # refresh with a full sweep next
            pending_refresh = True
    return cand, val


def _infer_H(batch, GH):
    # nonant names are u[g,h] blocks, unit-major; recover H from names
    names = batch.tree.nonant_names
    hs = [int(n.split(",")[1].rstrip("]")) for n in names[:GH]
          if n.startswith("u[")]
    return (max(hs) + 1) if hs else GH


def inparser_adder(cfg):
    cfg.num_scens_required()
    cfg.add_to_config("uc_hours", description="commitment horizon",
                      domain=int, default=6)
    cfg.add_to_config("uc_fleet_multiplier",
                      description="replicate the 3-unit fleet this "
                      "many times (jittered)", domain=int, default=1)
    cfg.add_to_config("uc_min_up_down",
                      description="enforce per-unit minimum up/down "
                      "times", domain=bool, default=False)
    cfg.add_to_config("uc_reserve_factor",
                      description="spinning-reserve requirement as a "
                      "fraction of hourly demand (0 disables)",
                      domain=float, default=0.0)


def kw_creator(options):
    return {"H": options.get("uc_hours", 6),
            "fleet_multiplier": options.get("uc_fleet_multiplier", 1),
            "min_up_down": options.get("uc_min_up_down", False),
            "reserve_factor": options.get("uc_reserve_factor", 0.0)}
