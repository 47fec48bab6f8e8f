"""Deterministic, seedable fault injection for the distributed stack.

The paper's convergence guarantee (Thm 2.1) assumes a strongly connected
network; production networks are not that polite.  This module models the
failure modes the roadmap's elasticity work needs — dropped links, straggling
agents, agents that crash and later rejoin, jittered step times — as a
declarative :class:`FaultSchedule` that *compiles* to plain numpy arrays:

* ``W_seq``        — (K, A, A) per-step row-stochastic mixing matrices
                     (the base ``W`` with dropped/crashed edges masked out and
                     rows renormalized);
* ``update_mask``  — (K, A) 0/1 per-step activity (stragglers and crashed
                     agents skip their local update);
* per-step fault counters (``links_dropped``, ``agents_isolated``,
  ``steps_degraded``, per-agent ``staleness``) for the obs JSONL.

Everything is sampled with ``np.random.SeedSequence([seed, step])`` so a
schedule is **byte-stable**: the same ``FaultSchedule`` always compiles to the
same arrays, on any host — the property the exp3 golden-run regression
baseline leans on.  The loop copies the compiled arrays to the device once
per run and indexes them with the (host integer) step, so the fault layer
adds no per-step copy and no wait for the device.

Degradation semantics (docs/robustness.md):

* a **dropped link** removes one directed edge for one step; the receiving
  row renormalizes over the surviving in-edges (weights keep summing to 1);
* a fully **isolated** agent's row becomes ``e_i`` — it falls back to a pure
  local optimizer step (FrODO memory intact) and re-synchronizes as soon as
  any in-edge returns;
* a **straggler** misses the local update for the step (gradient discarded,
  zero pushed into the memory window) but still mixes — its state is carried
  by its neighbors;
* a **crashed** agent neither updates nor communicates: its row and column
  are cut (row = ``e_i``) for the whole window, freezing its state until it
  rejoins, at which point consensus pulls it back toward the group.

Two link-drop models, selected by ``drop_mode``:

* ``"directed"`` (default) — each directed edge drops independently and the
  receiving row renormalizes over its surviving in-edges.  Row-stochasticity
  survives but double stochasticity does not, so the network mean
  random-walks (the mean-drift floor of docs/robustness.md).
* ``"symmetric"`` — an undirected failure takes both directions of a link
  at once, and the dropped off-diagonal mass is absorbed into the two
  endpoint *diagonals* instead of renormalizing (``mask_and_absorb``).  A
  symmetric doubly stochastic base ``W`` stays doubly stochastic under
  every mask, the network mean is conserved exactly, and the drift floor
  disappears — the failure model of a link (cable/switch) rather than a
  one-way packet loss.

This is a copy of the JAX package's ``repro.core.faults`` (plain numpy), kept
so the port never imports that package; a schedule compiles to the same
arrays, bit for bit, in both.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.core import graph as G

#: counter keys every compiled schedule exposes (JSONL field names)
FAULT_COUNTER_NAMES = ("faults_links_dropped", "faults_agents_isolated",
                      "faults_steps_degraded", "faults_staleness_max",
                      "faults_staleness_mean")


@dataclasses.dataclass(frozen=True)
class CrashWindow:
    """Agent ``agent`` is down for steps ``start <= k < stop`` (rejoins at
    ``stop``)."""
    agent: int
    start: int
    stop: int

    def __post_init__(self):
        if self.start < 0 or self.stop <= self.start:
            raise ValueError(f"bad crash window [{self.start}, {self.stop})")

    def active(self, k: int) -> bool:
        return self.start <= k < self.stop


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Declarative fault scenario; ``compile`` turns it into arrays.

    ``link_drop``       — i.i.d. per-step, per-directed-edge drop probability.
    ``drop_mode``       — ``"directed"`` (independent one-way drops, rows
                          renormalized) or ``"symmetric"`` (undirected link
                          failures, dropped mass absorbed to the diagonal so
                          a doubly stochastic W stays doubly stochastic).
    ``straggler_frac``  — fraction of agents (rounded down) that straggle
                          each step; the straggling set is resampled per step.
    ``crashes``         — crash-and-rejoin windows (see ``CrashWindow``).
    ``jitter_ms``       — mean of an exponential per-step step-time inflation
                          (simulated; experiments add it to
                          ``step_time_ms``).
    ``seed``            — base seed; all sampling is ``SeedSequence([seed,
                          stream, step])`` so schedules are byte-stable.
    """
    link_drop: float = 0.0
    straggler_frac: float = 0.0
    crashes: Tuple[CrashWindow, ...] = ()
    jitter_ms: float = 0.0
    seed: int = 0
    drop_mode: str = "directed"

    def __post_init__(self):
        if not (0.0 <= self.link_drop <= 1.0):
            raise ValueError("link_drop must be in [0, 1]")
        if not (0.0 <= self.straggler_frac < 1.0):
            raise ValueError("straggler_frac must be in [0, 1)")
        if self.jitter_ms < 0:
            raise ValueError("jitter_ms must be >= 0")
        if self.drop_mode not in ("directed", "symmetric"):
            raise ValueError(f"unknown drop_mode {self.drop_mode!r} "
                             "(expected 'directed' or 'symmetric')")

    # ------------------------------------------------------------- sampling

    def _rng(self, stream: int, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, stream, step]))

    def link_mask(self, k: int, A: np.ndarray) -> np.ndarray:
        """(A, A) 0/1 keep-mask over the *directed edges* of adjacency ``A``
        at step ``k`` (diagonal/self-loops never drop).  In symmetric mode
        the upper-triangle draw is mirrored, so both directions of an
        undirected link fail together."""
        n = A.shape[0]
        keep = np.ones((n, n))
        if self.link_drop > 0.0:
            u = self._rng(0, k).random((n, n))
            if self.drop_mode == "symmetric":
                ut = np.triu(u, 1)
                u = ut + ut.T
            drops = u < self.link_drop
            keep = np.where((A > 0) & drops, 0.0, 1.0)
        np.fill_diagonal(keep, 1.0)
        return keep

    def stragglers(self, k: int, n: int) -> np.ndarray:
        """(n,) bool: which agents straggle (miss their update) at step k."""
        out = np.zeros(n, bool)
        m = int(self.straggler_frac * n)
        if m > 0:
            out[self._rng(1, k).choice(n, size=m, replace=False)] = True
        return out

    def crashed(self, k: int, n: int) -> np.ndarray:
        out = np.zeros(n, bool)
        for c in self.crashes:
            if c.active(k):
                if not (0 <= c.agent < n):
                    raise ValueError(f"crash agent {c.agent} out of range")
                out[c.agent] = True
        return out

    def jitter(self, k: int) -> float:
        if self.jitter_ms <= 0.0:
            return 0.0
        return float(self._rng(2, k).exponential(self.jitter_ms))

    # -------------------------------------------------------------- compile

    def compile(self, A: np.ndarray, K: int,
                weight_fn: Callable[[np.ndarray], np.ndarray]
                = G.uniform_weights) -> "CompiledFaults":
        """Bake K steps of this schedule against base adjacency ``A``.

        ``weight_fn(A) -> W`` builds the healthy mixing matrix; each step's
        ``W_t`` is that W with the step's dropped/crashed edges masked and,
        depending on ``drop_mode``, rows renormalized
        (``mask_and_renormalize``) or dropped mass absorbed into the
        diagonal (``mask_and_absorb`` — keeps a doubly stochastic W doubly
        stochastic).  Requires a nonnegative W — best-constant (Xiao–Boyd)
        weights on non-regular graphs can go negative, where per-edge
        masking is ill-defined.  Symmetric mode additionally requires a
        symmetric base W (mass absorption conserves column sums only when
        the two directions of a link carry equal weight).
        """
        A = (np.asarray(A, np.float64) > 0).astype(np.float64)
        n = A.shape[0]
        W_base = np.asarray(weight_fn(A), np.float64)
        if W_base.min() < -1e-12:
            raise ValueError(
                "fault masking requires a nonnegative base W; got entries as "
                f"low as {W_base.min():.3g} (use uniform/metropolis weights, "
                "or Xiao-Boyd on a regular topology)")
        if self.drop_mode == "symmetric":
            if not np.allclose(W_base, W_base.T, atol=1e-12):
                raise ValueError(
                    "symmetric drop mode requires a symmetric base W "
                    "(metropolis weights, or uniform/Xiao-Boyd on a regular "
                    "topology)")
            mask_fn = mask_and_absorb
        else:
            mask_fn = mask_and_renormalize

        W_seq = np.empty((K, n, n))
        update_mask = np.ones((K, n))
        links_dropped = np.zeros(K, np.int64)
        agents_isolated = np.zeros(K, np.int64)
        jitter_ms = np.zeros(K)
        staleness = np.zeros((K, n), np.int64)
        stale = np.zeros(n, np.int64)
        base_edges = (A > 0) & ~np.eye(n, dtype=bool)

        for k in range(K):
            keep = self.link_mask(k, A)
            down = self.crashed(k, n)
            if down.any():
                keep[down, :] = 0.0
                keep[:, down] = 0.0
                np.fill_diagonal(keep, 1.0)
            W_t, isolated = mask_fn(W_base, keep)
            if down.any():
                # a crashed agent holds its state exactly (row = e_i)
                W_t[down, :] = 0.0
                W_t[down, down] = 1.0
            W_seq[k] = W_t
            active = ~(self.stragglers(k, n) | down)
            update_mask[k] = active.astype(np.float64)
            links_dropped[k] = int((base_edges & (keep == 0.0)).sum())
            agents_isolated[k] = int(isolated.sum())
            jitter_ms[k] = self.jitter(k)
            stale = np.where(active, 0, stale + 1)
            staleness[k] = stale

        return CompiledFaults(schedule=self, W_base=W_base, W_seq=W_seq,
                              update_mask=update_mask,
                              links_dropped=links_dropped,
                              agents_isolated=agents_isolated,
                              jitter_ms=jitter_ms, staleness=staleness)


def mask_and_renormalize(W: np.ndarray, keep: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero masked entries of a nonnegative row-stochastic ``W`` and
    renormalize each row over what survives.

    Self-weights never drop (``keep`` diagonal is forced on), so a row whose
    in-edges all vanish degrades to ``e_i`` — the *local-step fallback* —
    even when the base ``W`` had a zero self-weight.  Returns ``(W_t,
    isolated)`` where ``isolated`` flags rows left with no in-neighbors.
    """
    W = np.asarray(W, np.float64)
    keep = np.asarray(keep, np.float64).copy()
    n = W.shape[0]
    np.fill_diagonal(keep, 1.0)
    M = W * keep
    offdiag = M * (1.0 - np.eye(n))
    isolated = offdiag.sum(axis=1) <= 0.0
    rows = M.sum(axis=1)
    dead = rows <= 0.0          # zero self-weight and everything dropped
    if dead.any():
        M[dead, :] = 0.0
        M[dead, dead] = 1.0
        rows = M.sum(axis=1)
    return M / rows[:, None], isolated


def mask_and_absorb(W: np.ndarray, keep: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric-failure masking: dropped off-diagonal mass moves onto the
    *diagonal* instead of being renormalized away.

    For a symmetric ``keep`` mask and a symmetric doubly stochastic ``W``
    (Metropolis anywhere, uniform/Xiao–Boyd on regular topologies) the
    masked ``W_t`` is again symmetric and doubly stochastic: row ``i`` keeps
    summing to 1 because its dropped mass lands on ``W_t[i, i]``, and column
    sums follow by symmetry.  Double stochasticity conserves the network
    mean exactly, so symmetric drops degrade only the mixing *rate* — there
    is no mean-drift floor (docs/robustness.md).  Returns ``(W_t,
    isolated)`` with ``isolated`` flagging rows whose off-diagonal mass all
    dropped (pure local step, as in ``mask_and_renormalize``).
    """
    W = np.asarray(W, np.float64)
    keep = np.asarray(keep, np.float64).copy()
    n = W.shape[0]
    np.fill_diagonal(keep, 1.0)
    M = W * keep
    dropped = (W * (1.0 - keep)).sum(axis=1)
    M[np.arange(n), np.arange(n)] += dropped
    offdiag = M * (1.0 - np.eye(n))
    isolated = offdiag.sum(axis=1) <= 0.0
    return M, isolated


@dataclasses.dataclass(frozen=True)
class CompiledFaults:
    """A schedule baked against one topology for K steps (plain numpy)."""
    schedule: FaultSchedule
    W_base: np.ndarray            # (A, A) healthy mixing matrix
    W_seq: np.ndarray             # (K, A, A) per-step masked + renormalized
    update_mask: np.ndarray       # (K, A) 1 = agent runs its local update
    links_dropped: np.ndarray     # (K,) directed edges missing vs base
    agents_isolated: np.ndarray   # (K,) rows with no surviving in-neighbors
    jitter_ms: np.ndarray         # (K,) simulated step-time inflation
    staleness: np.ndarray         # (K, A) steps since the agent last updated

    @property
    def n_steps(self) -> int:
        return self.W_seq.shape[0]

    @property
    def n_agents(self) -> int:
        return self.W_seq.shape[1]

    def steps_degraded(self) -> np.ndarray:
        """(K,) 0/1: any fault visible at the step (drop, straggle, crash)."""
        return ((self.links_dropped > 0)
                | (self.update_mask < 1.0).any(axis=1)).astype(np.int64)

    def counters(self, k: int) -> Dict[str, float]:
        """Host-side per-step counter record (JSONL-ready scalars)."""
        return {
            "faults_links_dropped": int(self.links_dropped[k]),
            "faults_agents_isolated": int(self.agents_isolated[k]),
            "faults_steps_degraded": int(self.steps_degraded()[k]),
            "faults_staleness_max": int(self.staleness[k].max()),
            "faults_staleness_mean": float(self.staleness[k].mean()),
        }

    def counter_arrays(self) -> Dict[str, np.ndarray]:
        """Per-step counter trajectories keyed like ``counters`` — constants
        the loop indexes with the step (see ``core.loop``)."""
        return {
            "faults_links_dropped": self.links_dropped.astype(np.float32),
            "faults_agents_isolated":
                self.agents_isolated.astype(np.float32),
            "faults_steps_degraded": self.steps_degraded().astype(np.float32),
            "faults_staleness_max":
                self.staleness.max(axis=1).astype(np.float32),
            "faults_staleness_mean":
                self.staleness.mean(axis=1).astype(np.float32),
        }

    def validate(self, B: int) -> bool:
        """True when every length-``B`` window of the compiled ``W_seq``
        stays B-strongly-connected (Thm 2.1's assumption holds jointly —
        see ``graph.is_b_strongly_connected``)."""
        return G.is_b_strongly_connected(self.W_seq, B)
