"""Hot swap with canary generations: admit new weights into a running
service, canary them, never drop a live session.  The counterpart of
``distributedpytorch_tpu/serve/swap.py``.

A long-running service takes retrained weights without a restart (a
restart costs every session its cached features, and the first requests
their cuDNN and kernel warm-up).  The mechanism is a **generation pool**:

* Every weight set is a *generation* (:class:`Generation`); the service's
  first predictor is generation 0.  :meth:`PredictorPool.begin_swap`
  admits a NEW predictor beside the old one (both resident: a swap window
  costs one extra weight set of device memory) as the *canary*.
* **Routing.**  New sessions and stateless requests go to the canary with
  probability ``canary_fraction``: a session by the crc32 of its id, a
  stateless request by a round-robin counter.  Existing sessions are
  never re-routed: features encoded by generation N decode only with
  generation N's weights, so a session keeps its generation for life.
* **Decide.**  The service worker reports every request's outcome to
  :meth:`PredictorPool.observe`.  A non-finite output of the canary (a
  NaN-poisoned checkpoint) rolls it back at once; an error rate above
  ``max_error_rate`` after ``min_observations`` rolls it back;
  ``promote_after`` clean observations promote it (``None``: only a
  manual :meth:`PredictorPool.promote`).
* **Drain, then retire.**  After a promote the old generation *drains*:
  it serves its remaining sessions' warm clicks until the store holds
  none of them and nothing of it is in flight; then :meth:`PredictorPool
  .gc` drops the pool's reference, and its weights are freed.  The gauge
  ``serve_params_generations_live`` shows the window; the counter
  ``serve_swaps_total{outcome=promoted|rolled_back}`` counts decisions.

The pool never touches the session store: the service acts on the
decision strings :meth:`PredictorPool.observe` returns (a rollback evicts
the canary's sessions).  :func:`load_swap_predictor` is the seam new
weights come in through.
"""

from __future__ import annotations

import copy
import threading
import zlib

from ..telemetry import events as events_lib

#: generation lifecycle states
STATES = ("active", "canary", "draining", "retired")


def load_swap_predictor(base_predictor, state_dict, model=None, **kwargs):
    """A new generation's predictor from a port ``state_dict``.

    Every swap source funnels its weights here.  The ``serve/swap_params``
    chaos site fires on the state dict (a ``nan`` fault poisons every
    float tensor: a poisoned checkpoint, which the canary must roll back).
    The weights load strictly into ``model``, or into a new model of the
    base predictor's architecture (a copy of its module; an int8 base's
    quantized layers get float weights back, so the new generation is a
    float32 one, as in the JAX package: quantize it with
    ``quantize.quantize_predictor`` for an int8 canary).  Resolution,
    relax, zero padding, alpha, guidance family, input channels, input
    mean and std, device and compute dtype come from the base predictor
    unless given, so the service's bucket ladder and paste-back stay
    valid."""
    from ..chaos import sites as chaos_sites
    from ..models.resnet import Conv2d
    from ..predict import Predictor

    state_dict = chaos_sites.fire("serve/swap_params", payload=state_dict)
    if model is None:
        model = copy.deepcopy(base_predictor.model)
        for module in model.modules():
            if isinstance(module, Conv2d) and module.quantized:
                module.unquantize_()
    model.load_state_dict(state_dict, strict=True)
    for attr in ("resolution", "relax", "zero_pad", "alpha", "guidance",
                 "in_channels", "mean", "std", "device", "dtype"):
        kwargs.setdefault(attr, getattr(base_predictor, attr))
    return Predictor(model, **kwargs)


class Generation:
    """One resident weight set and its health counters."""

    __slots__ = ("gen_id", "predictor", "label", "state",
                 "ok", "errors", "nonfinite", "inflight")

    def __init__(self, gen_id: int, predictor, label: str,
                 state: str = "active"):
        self.gen_id = gen_id
        self.predictor = predictor
        self.label = label
        self.state = state
        self.ok = 0
        self.errors = 0
        self.nonfinite = 0
        self.inflight = 0

    def snapshot(self) -> dict:
        return {"gen": self.gen_id, "label": self.label,
                "state": self.state, "ok": self.ok, "errors": self.errors,
                "nonfinite": self.nonfinite, "inflight": self.inflight}


class SwapInProgressError(RuntimeError):
    """A swap while a canary is still undecided: promote or roll back
    first (two undecided canaries would make error attribution and the
    rollback target ambiguous)."""


class PredictorPool:
    """Owns the predictor generations; thread-safe for the service's
    submitting threads and its worker."""

    def __init__(self, predictor, registry=None,
                 canary_fraction: float = 0.1,
                 min_observations: int = 20,
                 max_error_rate: float = 0.1,
                 promote_after: int | None = 50):
        from ..telemetry.registry import get_registry

        self._lock = threading.Lock()
        self._gens: dict[int, Generation] = {
            0: Generation(0, predictor, "initial", "active")}
        self._next_id = 1
        self._active = 0
        self._canary: int | None = None
        self._rr = 0  # the stateless round-robin counter
        self.canary_fraction = float(canary_fraction)
        self.min_observations = int(min_observations)
        self.max_error_rate = float(max_error_rate)
        self.promote_after = promote_after
        reg = registry or get_registry()
        self._c_swap = {
            outcome: reg.counter("serve_swaps_total", "hot-swap decisions",
                                 labels={"outcome": outcome})
            for outcome in ("promoted", "rolled_back")}
        #: registry values at construction: the registry keeps process
        #: totals, the pool reports its own
        self._base_swaps = {o: c.value for o, c in self._c_swap.items()}
        self._g_live = reg.gauge("serve_params_generations_live",
                                 "resident param generations")
        self._g_live.set(1.0)

    # ------------------------------------------------------------- routing

    @property
    def active_generation(self) -> int:
        with self._lock:
            return self._active

    @property
    def canary_generation(self) -> int | None:
        with self._lock:
            return self._canary

    @property
    def active_predictor(self):
        with self._lock:
            return self._gens[self._active].predictor

    def predictor_for(self, gen_id: int):
        with self._lock:
            return self._gens[gen_id].predictor

    def route(self, session_id: str | None) -> tuple[int, object]:
        """(generation id, predictor) for a new session or a stateless
        request.  A session id hashes (crc32) to a fixed side, so a session
        that re-encodes mid-canary lands where it did; stateless requests
        round-robin, so a canary sees traffic even from one client."""
        with self._lock:
            gen = self._active
            if self._canary is not None:
                if session_id is None:
                    self._rr += 1
                    frac = (self._rr % 1000) / 1000.0
                else:
                    frac = (zlib.crc32(session_id.encode("utf-8"))
                            % 1000) / 1000.0
                if frac < self.canary_fraction:
                    gen = self._canary
            return gen, self._gens[gen].predictor

    def track_inflight(self, gen_id: int, delta: int) -> None:
        with self._lock:
            g = self._gens.get(gen_id)
            if g is not None:
                g.inflight += delta

    def is_resident(self, predictor) -> bool:
        """Whether a live generation still holds ``predictor``: the
        service drops its own reference to its first predictor once that
        generation retires, or those weights would stay on the card."""
        with self._lock:
            return any(g.predictor is predictor for g in self._gens.values())

    # ---------------------------------------------------------------- swap

    def begin_swap(self, predictor, label: str = "",
                   canary_fraction: float | None = None) -> int:
        """Admit a built predictor (weights resident) as the canary;
        returns its generation id.  Loading is the caller's, so a failed
        load never leaves the pool half-swapped."""
        with self._lock:
            if self._canary is not None:
                raise SwapInProgressError(
                    f"generation {self._canary} is still canarying — "
                    "promote() or rollback() before swapping again")
            gen_id = self._next_id
            self._next_id += 1
            self._gens[gen_id] = Generation(
                gen_id, predictor, label or f"swap-{gen_id}", "canary")
            self._canary = gen_id
            if canary_fraction is not None:
                self.canary_fraction = float(canary_fraction)
            self._publish()
            events_lib.emit("serve", "swap_admit",
                            payload={"gen_id": gen_id,
                                     "label": self._gens[gen_id].label,
                                     "canary_fraction":
                                         self.canary_fraction})
            return gen_id

    def observe(self, gen_id: int, ok: bool,
                nonfinite: bool = False) -> str | None:
        """Book one request's outcome; returns the decision it triggered
        (``"promoted"`` | ``"rolled_back"``) or None."""
        with self._lock:
            g = self._gens.get(gen_id)
            if g is None:
                return None
            if ok and not nonfinite:
                g.ok += 1
            else:
                g.errors += 1
                if nonfinite:
                    g.nonfinite += 1
            if gen_id != self._canary:
                return None
            # the decision table, most urgent first
            if g.nonfinite:
                return self._rollback_locked()
            total = g.ok + g.errors
            if (total >= self.min_observations
                    and g.errors / total > self.max_error_rate):
                return self._rollback_locked()
            if (self.promote_after is not None
                    and g.ok >= self.promote_after
                    and (total == 0
                         or g.errors / total <= self.max_error_rate)):
                return self._promote_locked()
            return None

    def promote(self) -> dict:
        """Promote the canary to active; the old active drains."""
        with self._lock:
            if self._canary is None:
                raise RuntimeError("no canary generation to promote")
            self._promote_locked()
            return self.snapshot_locked()

    def rollback(self) -> dict:
        """Roll the canary back (the caller evicts its sessions)."""
        with self._lock:
            if self._canary is None:
                raise RuntimeError("no canary generation to roll back")
            self._rollback_locked()
            return self.snapshot_locked()

    def gc(self, sessions_by_generation: dict[int, int]) -> list[int]:
        """Retire drained generations: neither active nor canary, no live
        session in the store, nothing in flight.  Returns the ids whose
        weights were just released."""
        freed = []
        with self._lock:
            for gen_id, g in list(self._gens.items()):
                if gen_id in (self._active, self._canary):
                    continue
                if (g.inflight == 0
                        and sessions_by_generation.get(gen_id, 0) == 0
                        and g.predictor is not None):
                    g.predictor = None  # the weights go with the last ref
                    g.state = "retired"
                    freed.append(gen_id)
            if freed:
                self._publish()
        return freed

    # ---------------------------------------------------------------- ops

    def swaps(self) -> dict:
        """{'promoted': n, 'rolled_back': n} since the pool was made."""
        return {o: int(c.value - self._base_swaps[o])
                for o, c in self._c_swap.items()}

    def snapshot(self) -> dict:
        with self._lock:
            return self.snapshot_locked()

    def snapshot_locked(self) -> dict:
        return {
            "active": self._active,
            "canary": self._canary,
            "canary_fraction": self.canary_fraction,
            "swaps": self.swaps(),
            "generations": [g.snapshot()
                            for _, g in sorted(self._gens.items())],
        }

    # ------------------------------------------------------------ internals

    def _promote_locked(self) -> str:
        old_active = self._gens[self._active]
        gen = self._gens[self._canary]
        gen.state = "active"
        self._active = self._canary
        self._canary = None
        old_active.state = "draining"
        self._c_swap["promoted"].inc()
        self._publish()
        events_lib.emit("serve", "swap_promote",
                        payload={"gen_id": gen.gen_id, "label": gen.label,
                                 "ok": gen.ok, "errors": gen.errors})
        return "promoted"

    def _rollback_locked(self) -> str:
        g = self._gens[self._canary]
        g.state = "draining"  # its in-flight work still needs the weights
        self._canary = None
        self._c_swap["rolled_back"].inc()
        self._publish()
        events_lib.emit("serve", "swap_rollback",
                        payload={"gen_id": g.gen_id, "label": g.label,
                                 "ok": g.ok, "errors": g.errors,
                                 "nonfinite": g.nonfinite})
        return "rolled_back"

    def _publish(self) -> None:
        self._g_live.set(float(sum(
            1 for g in self._gens.values() if g.predictor is not None)))
