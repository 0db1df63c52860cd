"""Streamed partition transfers: ladder-aligned chunk planning and the
online transfer autotuner.

A copy of ``cekirdekler_tpu/core/stream.py`` with its arithmetic unchanged
(the port never imports the JAX package), with the reference's hooks: the
``transfer-choose`` and ``transfer-observe`` decision records (their
inputs the tuner's stored state before the call changes it, so the
reference's replayer re-executes them too) and the ``stream-retune``
flight event.  On a GPU lane the execution half is
``Cores._run_streamed`` with the ``Worker`` chunk primitives, which copy on
the lane's copy streams while its compute stream runs the chunks' kernels.
The text below is the reference's.

The reference hides host↔device latency with 16 command queues doing
read/compute/write pipelining (SURVEY §design point b).  Our cross-lane
analogue has existed since r3 (async XLA dispatch per lane), but WITHIN
one compute id's partition the upload was a single monolithic
``jax.device_put`` that had to fully land before the first ladder chunk
launched, and the download drained everything at once.  This module is
the planning half of the fix (the execution half is
``Cores._run_streamed`` + the Worker chunk primitives):

- :func:`chunk_plan` cuts a lane's range into ``step·2^k`` chunks —
  the SAME geometry the compile-once launch ladder uses, so every
  chunk's launch is a cached-executable hit and chunking never causes a
  recompile (the reason the chunk sizes are not simply ``size/c``).

- :class:`TransferTuner` picks the chunk count per (lane, kernel,
  bytes-bucket) from observed timings.  The model is the classic
  pipeline bound: with per-phase times U (upload), C (compute), D
  (download) and ``c`` chunks, the wall is approximately::

      est(c) = max(U, C, D) + (U + C + D - max(U, C, D)) / c + f·(c-1)

  (the dominant phase cannot be hidden; the others drain through the
  pipe in 1/c-sized pieces; every extra chunk pays a fixed dispatch
  cost ``f``).  The chosen count is the argmin over a power-of-two
  candidate grid, ties to the SMALLER count.  Properties the tests pin:

  * **deterministic** — same observations, same choice (no clocks, no
    randomness inside ``choose``);
  * **monotone** — scaling link latency up (U, D grow, C fixed) never
    DECREASES the chosen chunk count: the argmin of ``S/c + f·c``
    moves with ``sqrt(S/f)`` and each discrete crossing is upward;
  * **re-tunes on re-partition** — :meth:`on_repartition` drops the
    observations (the balancer moved the bytes, so they describe a
    partition that no longer exists) while keeping the duplex-probe
    link seed, so the next ``choose`` starts from link physics instead
    of stale measurements.

Two kinds of keys, two first-contact rules:

* **Compute keys** (a kernel runs between the transfers): the FIRST run
  is a deliberate monolithic *measuring run* — it observes U, C, D
  honestly (serial, nothing overlapped), and streaming starts from the
  second call with a model built on those numbers.  A chunked run can
  teach NONE of the phases honestly — its wall hides the overlap, and
  its per-phase host windows measure async *dispatch* cost, not link
  time — so chunked runs contribute two bounded corrections instead.
  The wall UPPER-BOUNDS every phase (all of U, C, D happen inside it),
  clamping estimates the measuring run contaminated — first contact is
  usually also first jit compile, which lands compile time in C — and
  they refine the lane's *per-chunk overhead*:
  ``implied = (wall − overhead-free model) / (c − 1)``, EMA'd per lane
  against the STORED monolithic estimates.  This is the
  self-correction that matters across rigs — a TPU lane's chunk costs
  sub-ms host dispatch, a CPU-interpreter lane's costs tens of ms, and
  a fixed constant would over-chunk the latter forever.  (U/C/D
  freshness comes from the measuring runs themselves: every
  :meth:`on_repartition` — and every model flip back to 1 chunk —
  re-measures.)

* **No-compute keys** (``has_compute=False`` — the flush drain's pure
  D2H records): nothing to measure serially, so the duplex-probe seed
  (:meth:`seed_link`, ms/MiB each direction — what
  ``workloads.measure_stream_overlap(duplex_probe=True)`` measures
  anyway) drives the model directly; with no seed either, transfers of
  at least :data:`BOOTSTRAP_BYTES` get :data:`BOOTSTRAP_CHUNKS` chunks
  and smaller ones stay monolithic.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..obs.decisions import DECISIONS
from .worker import launch_ladder

__all__ = [
    "chunk_plan",
    "plan_signature",
    "TransferTuner",
    "CHUNK_CANDIDATES",
    "BOOTSTRAP_BYTES",
    "BOOTSTRAP_CHUNKS",
]

#: Candidate chunk counts (power-of-two grid: chunk sizes stay ladder
#: shaped and the search is O(1)).
CHUNK_CANDIDATES = (1, 2, 4, 8, 16, 32)

#: With neither observations nor a link seed, transfers at least this
#: large stream in BOOTSTRAP_CHUNKS chunks (first-run overlap + the
#: observation that tunes the next run); smaller ones stay monolithic.
BOOTSTRAP_BYTES = 1 << 20
BOOTSTRAP_CHUNKS = 4

#: After this many consecutive clamp-only (unfenced monolithic)
#: observations a key's estimates are considered stale and dropped —
#: clamps only ever pull estimates DOWN, so a key parked at 1 chunk
#: could never notice a link that got slower (re-measure cost: one
#: fence, amortized over the streak).
REMEASURE_AFTER = 32

#: Default fixed per-chunk dispatch cost (ms) — one extra staged H2D +
#: one extra ladder launch + one extra D2H issue.  Host-dispatch scale,
#: not device scale; refined per instance via ``overhead_ms``.
PER_CHUNK_OVERHEAD_MS = 0.15


def chunk_plan(size: int, step: int, target: int) -> list[tuple[int, int]]:
    """Cut ``size`` (a multiple of ``step``) into ladder-aligned chunks:
    every chunk is ``step·2^k`` for some k, so each chunk's launch rides
    an already-compiled ladder executable.  Returns ``[(offset, size),
    ...]`` in ascending-offset order with at least ``min(target,
    size//step)`` chunks: the binary-ladder decomposition of ``size`` is
    the starting plan, and the largest splittable chunk is halved (a
    power of two splits into two powers of two) until the target count
    is reached."""
    if step <= 0 or size % step != 0:
        raise ValueError(f"size {size} must be a positive multiple of step {step}")
    # the launcher's OWN decomposition (worker.launch_ladder) is the
    # starting plan — one source of truth for the geometry the compile
    # cache is keyed on
    sizes: list[int] = launch_ladder(size, step)
    target = max(1, int(target))
    while len(sizes) < target:
        i = max(range(len(sizes)), key=lambda k: sizes[k])
        if sizes[i] <= step:
            break  # every chunk is already one step — can't split further
        half = sizes[i] // 2
        sizes[i] = half
        sizes.insert(i + 1, half)
    out: list[tuple[int, int]] = []
    off = 0
    for s in sorted(sizes, reverse=True):
        out.append((off, s))
        off += s
    return out


def plan_signature(plan) -> str:
    """Canonical "blocks" signature of a chunk/ladder geometry:
    descending chunk sizes joined with ``+`` (e.g. ``"4096+2048+512"``).

    Accepts :func:`chunk_plan` output (``[(offset, size), ...]``) or a
    bare size list (``worker.launch_ladder`` output).  This string is the
    ``blocks`` component of kernel-profile store keys
    (``trace/device.ProfileStore``) — the same kernel at two chunk
    geometries is two different device-time stories, and launch marks
    correlated per geometry must never collide in the store.  It is
    also the ladder-geometry component of the persistent executable
    cache's cross-process key (``core/compilecache.CompileCache
    .ladder_key``) — ONE canonical geometry string on purpose: a
    second spelling would let a profile row and a cached executable
    describe "the same" ladder under different keys."""
    sizes = [
        int(p[1]) if isinstance(p, (tuple, list)) else int(p) for p in plan
    ]
    return "+".join(str(s) for s in sizes) or "0"


@dataclass
class _LinkSeed:
    """Per-lane duplex-probe seed: transfer cost in ms per MiB each
    direction (what the probe measures), plus the probe's fixed cost."""

    h2d_ms_per_mib: float
    d2h_ms_per_mib: float


@dataclass
class _Obs:
    """EMA of one (lane, kernel, bytes-bucket)'s observed phase times."""

    u_ms: float
    c_ms: float
    d_ms: float
    count: int = 1
    #: consecutive clamp-only (unfenced monolithic) observations since
    #: the last honest measurement — clamps can only pull estimates
    #: DOWN, so a long clamp-only streak means the model is blind to a
    #: link that got SLOWER; at REMEASURE_AFTER the key re-measures
    stale: int = 0


class TransferTuner:
    """Online chunk-count autotuner (see module docstring).  Thread-safe:
    workers observe concurrently; ``choose`` reads a consistent row."""

    def __init__(
        self,
        overhead_ms: float = PER_CHUNK_OVERHEAD_MS,
        candidates: tuple[int, ...] = CHUNK_CANDIDATES,
        ema: float = 0.5,
    ):
        self.overhead_ms = float(overhead_ms)
        self.candidates = tuple(sorted(set(int(c) for c in candidates)))
        self.ema = float(ema)
        self._seed: dict[int, _LinkSeed] = {}
        self._obs: dict[tuple, _Obs] = {}
        # per-lane LEARNED per-chunk overhead (ms): the default constant
        # is host-dispatch scale (right for a TPU lane), but a CPU-rig
        # chunk dispatch costs 100x that — a fixed constant would make
        # the model over-chunk there forever.  Every observed streamed
        # run implies an overhead ((wall − pipeline model) / (c − 1));
        # the EMA of that implication replaces the constant per lane.
        self._overhead: dict[int, float] = {}
        # last model choice per key — a flip from >1 back to 1 drops
        # the key's observation so the flip's run re-measures (module
        # docstring's freshness promise; without it the 1-chunk regime
        # is clamp-only and could never re-engage streaming)
        self._last_choice: dict[tuple, int] = {}
        # on_repartition() count — a superset of ck_stream_retune_total,
        # which only the balancer's re-partition path increments
        # (measure_stream_overlap's deliberate warmup drop rides this
        # counter too, and subtracts its own baseline when reporting)
        self.retunes = 0
        self._mu = threading.Lock()

    # -- keys ----------------------------------------------------------------
    @staticmethod
    def bytes_bucket(nbytes: int) -> int:
        """Power-of-two ceiling bucket: ±quantization-step balancer moves
        stay in one bucket (no thrash); a real re-partition is followed
        by :meth:`on_repartition` anyway."""
        n = max(int(nbytes), 1)
        return 1 << (n - 1).bit_length()

    def _key(self, lane: int, kernel_key, nbytes: int) -> tuple:
        return (lane, kernel_key, self.bytes_bucket(nbytes))

    # -- inputs --------------------------------------------------------------
    def seed_link(
        self, lane: int, h2d_ms_per_mib: float, d2h_ms_per_mib: float
    ) -> None:
        """Seed a lane's link model from a duplex probe (ms per MiB per
        direction).  Used until the first streamed run of a key is
        observed, and again after every :meth:`on_repartition`."""
        with self._mu:
            self._seed[lane] = _LinkSeed(
                max(float(h2d_ms_per_mib), 0.0), max(float(d2h_ms_per_mib), 0.0)
            )

    def observe(
        self,
        lane: int,
        kernel_key,
        nbytes: int,
        u_ms: float,
        c_ms: float,
        d_ms: float,
        chunks: int = 1,
        wall_ms: float | None = None,
        fenced: bool = False,
    ) -> None:
        """Record one streamed (or monolithic) run's measured phase times
        for the key.  EMA so link weather tracks without one spike
        owning the estimate.  Only a FENCED monolithic run (``fenced``:
        the caller paid a device fence between the launches and the D2H
        window — the measuring-run protocol) may EMA the phases: an
        unfenced monolithic run's async launches retire inside its D2H
        timing window, so its split degenerates to ``(U, ~0, C+D)`` and
        EMA'ing it would teach the model an unhideable peak and turn the
        streamed path off for keys where true C dominates.  Unfenced
        monolithic runs clamp only (their TOTAL wall is still an honest
        upper bound on each phase).  A chunked run (``chunks`` > 1)
        clamps the stored phase estimates at its wall (an upper bound on
        each — the self-heal for compile-contaminated measuring runs)
        and teaches the lane's real per-chunk overhead (from its
        ``wall_ms`` in excess of the overhead-free pipeline model): its
        per-phase host windows measure async *dispatch* cost, not link
        time — EMA'ing those into U/D would decay the honest monolithic
        estimates toward zero, flip the model back to 1 chunk, and
        oscillate the path between streamed and monolithic forever.

        Records one ``transfer-observe`` decision (arguments + the
        pre-call stored state → the post-call stored state) so the
        model-update arithmetic itself is replay-verifiable."""
        key = self._key(lane, kernel_key, nbytes)
        u, c, d = max(u_ms, 0.0), max(c_ms, 0.0), max(d_ms, 0.0)
        rec = post = None
        with self._mu:
            cur = self._obs.get(key)
            if DECISIONS.enabled:
                rec = {
                    "lane": int(lane), "kernel_key": kernel_key,
                    "nbytes": int(nbytes),
                    "bucket": self.bytes_bucket(nbytes),
                    "u_ms": u, "c_ms": c, "d_ms": d,
                    "chunks": int(chunks),
                    "wall_ms": None if wall_ms is None else float(wall_ms),
                    "fenced": bool(fenced),
                    "obs": None if cur is None else {
                        "u_ms": cur.u_ms, "c_ms": cur.c_ms,
                        "d_ms": cur.d_ms, "count": cur.count,
                        "stale": cur.stale,
                    },
                    "overhead_ms": self._overhead.get(
                        lane, self.overhead_ms),
                    "default_overhead_ms": self.overhead_ms,
                    "ema": self.ema,
                }
            if cur is None:
                if chunks > 1:
                    # a chunked run cannot decompose its own wall into
                    # honest phases (the overlap is what it hides) —
                    # without a monolithic baseline there is nothing
                    # sound to store
                    if rec is not None:
                        DECISIONS.record("transfer-observe", rec,
                                         {"stored": False})
                    return
                # first contact stores unconditionally: the engine's
                # measuring-run protocol guarantees it is fenced, and a
                # direct caller teaching the tuner is the baseline
                cur = self._obs[key] = _Obs(u, c, d)
            elif chunks <= 1:
                if fenced:
                    # only a FENCED serial run measures any phase honestly
                    a = self.ema
                    cur.u_ms += a * (u - cur.u_ms)
                    cur.d_ms += a * (d - cur.d_ms)
                    cur.c_ms += a * (c - cur.c_ms)
                    cur.count += 1
                    cur.stale = 0
                elif wall_ms is not None:
                    # unfenced monolithic fallback (the tuner chose 1
                    # chunk, so no measuring fence was paid): the split
                    # is async-contaminated, but the serial wall still
                    # upper-bounds every phase — clamp-only, so link
                    # weather can pull estimates DOWN without the
                    # contaminated split ever entering the EMA
                    bound = max(wall_ms, 0.0)
                    cur.u_ms = min(cur.u_ms, bound)
                    cur.c_ms = min(cur.c_ms, bound)
                    cur.d_ms = min(cur.d_ms, bound)
                    cur.stale += 1
                    if cur.stale >= REMEASURE_AFTER:
                        # clamp-only streak: the model can only have
                        # drifted DOWN — drop the key so its next run
                        # is a fresh fenced measuring run (a slower
                        # link is invisible to clamps)
                        del self._obs[key]
            if chunks > 1 and wall_ms is not None:
                # a chunked wall UPPER-BOUNDS every phase (all of U, C,
                # D happen inside it) — clamp stored estimates above it.
                # This is the self-heal for measuring-run compile
                # contamination: first contact is usually also first jit
                # compile, which lands compile time in C; the inflated
                # peak flattens the model curve (rest/c and overhead
                # become rounding error next to it), the first choice
                # degenerates to the largest candidate, and every
                # implied overhead clamps at 0 against the oversized
                # base — over-chunking would freeze in place.  One
                # honest chunked wall snaps the estimates back to
                # physics.
                bound = max(wall_ms, 0.0)
                cur.u_ms = min(cur.u_ms, bound)
                cur.c_ms = min(cur.c_ms, bound)
                cur.d_ms = min(cur.d_ms, bound)
                cur.stale = 0  # streaming engaged — the key is not parked
                # the lane's real per-chunk cost, implied by this wall
                # against the overhead-free pipeline model built on the
                # STORED (monolithic-honest, wall-clamped) estimates
                eu, ec, ed = cur.u_ms, cur.c_ms, cur.d_ms
                peak = max(eu, ec, ed)
                base = peak + (eu + ec + ed - peak) / chunks
                implied = max((wall_ms - base) / (chunks - 1), 0.0)
                cur_ov = self._overhead.get(lane, self.overhead_ms)
                self._overhead[lane] = cur_ov + self.ema * (implied - cur_ov)
            if rec is not None:
                after = self._obs.get(key)  # None when the stale streak
                post = {                    # (or a flip) dropped the key
                    "stored": True,
                    "obs": None if after is None else {
                        "u_ms": after.u_ms, "c_ms": after.c_ms,
                        "d_ms": after.d_ms, "count": after.count,
                        "stale": after.stale,
                    },
                    "overhead_ms": self._overhead.get(
                        lane, self.overhead_ms),
                }
        if rec is not None:
            DECISIONS.record("transfer-observe", rec, post)

    def has_obs(self, lane: int, kernel_key, nbytes: int) -> bool:
        """Whether the key already has a stored (monolithic-honest)
        observation — False means the next run is its measuring run."""
        with self._mu:
            return self._key(lane, kernel_key, nbytes) in self._obs

    def lane_overhead_ms(self, lane: int) -> float:
        """The lane's current per-chunk overhead estimate (learned EMA,
        or the default constant before any chunked run taught it)."""
        with self._mu:
            return self._overhead.get(lane, self.overhead_ms)

    def on_repartition(self, lane: int | None = None) -> None:
        """The balancer moved shares: per-key observations describe
        partitions that no longer exist — drop them (all lanes, or one)
        and fall back to the link seed until re-observed."""
        with self._mu:
            if lane is None:
                dropped = len(self._obs)
                self._obs.clear()
                self._last_choice.clear()
            else:
                doomed = [k for k in self._obs if k[0] == lane]
                dropped = len(doomed)
                for k in doomed:
                    del self._obs[k]
                for k in [k for k in self._last_choice if k[0] == lane]:
                    del self._last_choice[k]
            self.retunes += 1
        # flight-record the decision (outside the lock — the recorder is
        # lock-free and must not nest under the tuner's mutex)
        from ..obs.flight import FLIGHT

        FLIGHT.event("stream-retune", lane=lane, dropped_keys=dropped)

    # -- the choice ----------------------------------------------------------
    def estimate(
        self, lane: int, kernel_key, nbytes: int
    ) -> tuple[float, float, float] | None:
        """(U, C, D) ms for the key: observation first, link seed (with
        unknown compute = 0) second, None when the tuner knows nothing."""
        key = self._key(lane, kernel_key, nbytes)
        with self._mu:
            obs = self._obs.get(key)
            if obs is not None:
                return (obs.u_ms, obs.c_ms, obs.d_ms)
            seed = self._seed.get(lane)
        if seed is None:
            return None
        mib = nbytes / float(1 << 20)
        return (seed.h2d_ms_per_mib * mib, 0.0, seed.d2h_ms_per_mib * mib)

    def predict_ms(
        self,
        est: tuple[float, float, float],
        chunks: int,
        overhead_ms: float | None = None,
    ) -> float:
        """The pipeline-bound wall model for ``chunks`` chunks."""
        u, c, d = est
        peak = max(u, c, d)
        rest = (u + c + d) - peak
        ov = self.overhead_ms if overhead_ms is None else overhead_ms
        return peak + rest / max(1, chunks) + ov * (chunks - 1)

    def choose(
        self,
        lane: int,
        kernel_key,
        nbytes: int,
        max_chunks: int,
        has_compute: bool = True,
    ) -> int:
        """Chunk count for this transfer: argmin of the model over the
        candidate grid (ties to the smaller count), capped at
        ``max_chunks`` (= range//step — a chunk cannot be smaller than
        one step).  First contact per compute key returns 1 — the
        monolithic measuring run that makes every later model honest;
        no-compute keys (``has_compute=False``) model from the duplex
        seed, or bootstrap by byte size with no seed either.

        Every call records one ``transfer-choose`` decision (the key,
        the stored estimates / seed / learned overhead it modeled from,
        and the chosen count) into ``obs.decisions.DECISIONS`` —
        replay-verify reconstructs a tuner from exactly that snapshot
        and asserts the same choice.  The decision inputs come from ONE
        consistent read under the mutex (previously ``estimate`` and
        ``lane_overhead_ms`` re-locked separately — a concurrent
        ``observe`` could change the row between reads)."""
        cap = max(1, int(max_chunks))
        key = self._key(lane, kernel_key, nbytes)
        with self._mu:
            # VALUE copies under the mutex: the _Obs/_LinkSeed objects
            # are EMA'd in place by concurrent observe() — reading their
            # fields after the lock drops could model (and record) torn
            # state, and the recorded snapshot would then disagree with
            # the choice replay-verify re-derives from it
            obs = self._obs.get(key)
            obs_vals = None if obs is None else (
                obs.u_ms, obs.c_ms, obs.d_ms, obs.count, obs.stale)
            seed = self._seed.get(lane)
            seed_vals = None if seed is None else (
                seed.h2d_ms_per_mib, seed.d2h_ms_per_mib)
            ov = self._overhead.get(lane, self.overhead_ms)
            rec = None
            if DECISIONS.enabled:
                rec = {
                    "lane": int(lane), "kernel_key": kernel_key,
                    "nbytes": int(nbytes),
                    "bucket": self.bytes_bucket(nbytes),
                    "max_chunks": cap, "has_compute": bool(has_compute),
                    "obs": None if obs_vals is None else {
                        "u_ms": obs_vals[0], "c_ms": obs_vals[1],
                        "d_ms": obs_vals[2], "count": obs_vals[3],
                        "stale": obs_vals[4],
                    },
                    "seed": None if seed_vals is None else {
                        "h2d_ms_per_mib": seed_vals[0],
                        "d2h_ms_per_mib": seed_vals[1],
                    },
                    "overhead_ms": ov,
                    "default_overhead_ms": self.overhead_ms,
                    "ema": self.ema,
                    "candidates": list(self.candidates),
                }
            if obs_vals is None and has_compute:
                self._last_choice[key] = 1
                if rec is not None:
                    DECISIONS.record("transfer-choose", rec,
                                     {"chunks": 1, "why": "measuring-run"})
                return 1  # the measuring run
        if obs_vals is not None:
            est = obs_vals[:3]
        elif seed_vals is not None:
            mib = nbytes / float(1 << 20)
            est = (seed_vals[0] * mib, 0.0, seed_vals[1] * mib)
        else:
            est = None
        if est is None:
            best_c = min(BOOTSTRAP_CHUNKS, cap) \
                if nbytes >= BOOTSTRAP_BYTES else 1
            if rec is not None:
                DECISIONS.record("transfer-choose", rec,
                                 {"chunks": best_c, "why": "bootstrap"})
            return best_c
        best_c, best_t = 1, None
        for c in self.candidates:
            if c > cap:
                break
            t = self.predict_ms(est, c, ov)
            if best_t is None or t < best_t - 1e-12:
                best_c, best_t = c, t
        with self._mu:
            prev = self._last_choice.get(key)
            if has_compute and best_c <= 1 and prev is not None and prev > 1:
                # flip back to 1 chunk: drop the observation so THIS
                # run becomes the key's fresh fenced measuring run —
                # the 1-chunk regime is clamp-only from here on and
                # could otherwise never re-engage streaming
                self._obs.pop(key, None)
            self._last_choice[key] = best_c
        if rec is not None:
            DECISIONS.record("transfer-choose", rec, {
                "chunks": best_c, "why": "model",
                "predicted_ms": best_t,
            })
        return best_c
