"""The mixture-of-experts FFN of DANet's head, the counterpart of
``distributedpytorch_tpu/parallel/moe.py``: top-1 (Switch) or top-2
routing with a fixed per-expert capacity, the expert MLPs, and the
router's load-balancing loss.

The semantics are the JAX package's, to the slot:

* the token set is every token handed in, the whole batch's ``B * N`` in
  row-major order, and each expert has ``ceil(tokens / E * factor)``
  slots (:func:`expert_capacity`);
* a token's slot is its exclusive-cumsum position among the tokens that
  chose the same expert; a token whose slot is ``>= capacity`` is dropped
  (combine weight 0, the caller's residual carries it);
* with ``k = 2`` the second choice's slots start after **all** the first
  round's choices of that expert, the dropped ones included;
* a gate is the raw softmax probability of the chosen expert, not
  renormalised over the ``k`` choices;
* the auxiliary loss is ``E * sum_e (frac_e / k) * mean_prob_e`` with
  ``frac_e`` counting every choice before the capacity cut.

JAX builds (N, E, C) one-hot ``dispatch`` and ``combine`` tensors, since
XLA needs static shapes.  At DANet-R101's head (N = 32768 tokens at
B = 8, E = 4, factor 1.25: C = 10240) each would be 5.4 GB in float32.
:func:`moe_ffn` computes the same function with indices: an (expert,
slot) pair and a keep flag per token and choice, a scatter of the kept
tokens into an (E, C, d) buffer (one ``index_add`` per round), the two
expert matmuls, a gather back (``index_select``) weighted by the gates.  Every shape is static (dropped tokens go to a
spare row that is cut off), so it also runs on the meta device, where
``telemetry.goodput.step_flops`` counts it: the expert products over all
``E * C`` slots, empty ones included, and none of JAX's dispatch einsums.
:func:`moe_ffn_dense` is the transcription of JAX's one-hot einsums, the
plain version the tests and ``chip_smoke.py`` hold :func:`moe_ffn` to;
no entry point runs it.

Everything here runs in float32 (float64 for float64 inputs), whatever
the model's compute dtype; DANet casts its fused features to float32
before the MoE and back after it, as the JAX head does.  Expert
parallelism (``make_expert_mesh``, ``ep_param_specs``,
``make_moe_apply``) is not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

#: the stacked parameters of one MoE FFN, in JAX's order
PARAM_NAMES = ("w_gate", "w1", "b1", "w2", "b2")


def expert_capacity(n_tokens: int, n_experts: int,
                    capacity_factor: float) -> int:
    """Per-expert token slots: ceil(tokens / experts * factor), min 1."""
    return max(1, math.ceil(n_tokens / n_experts * capacity_factor))


class Routing(NamedTuple):
    """Where each token goes, per round of top-``k`` routing: (k, N)
    tensors of the chosen ``expert``, its ``slot`` (which may lie past
    the capacity), ``keep`` (the slot lies inside it) and the ``gate``
    (the choice's softmax probability, differentiable); and the scalar
    load-balancing ``aux`` loss."""

    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _check_k(k: int, n_experts: int) -> None:
    if k > n_experts:
        # beyond E rounds every expert is masked and argmax would re-pick
        # expert 0, dispatching tokens twice
        raise ValueError(f"top-k routing needs k ({k}) <= experts "
                         f"({n_experts})")


def _probs(x: torch.Tensor, w_gate: torch.Tensor) -> torch.Tensor:
    dtype = _acc_dtype(x)
    return torch.softmax(x.to(dtype) @ w_gate.to(dtype), dim=-1)


def router(x: torch.Tensor, w_gate: torch.Tensor, *, k: int,
           capacity: int) -> Routing:
    """Top-``k`` routing of ``x`` (N, d) by ``w_gate`` (d, E) with
    ``capacity`` slots per expert, as indices (see the module
    docstring)."""
    n_experts = w_gate.shape[-1]
    _check_k(k, n_experts)
    probs = _probs(x, w_gate)
    experts = torch.arange(n_experts, device=x.device)
    masked = probs.detach()
    prior = torch.zeros(n_experts, dtype=torch.long, device=x.device)
    frac = torch.zeros(n_experts, dtype=probs.dtype, device=x.device)
    expert, slot, gate = [], [], []
    for _ in range(k):
        choice = masked.argmax(dim=-1)  # (N,), the first of equal maxima
        # (E, N): the scan runs along the contiguous token axis (CUDA's
        # scan over an outer axis of E columns is serial in N)
        onehot = experts[:, None] == choice
        counts = onehot.long()
        # tokens ahead with the same choice, after the earlier rounds' claims
        ahead = counts.cumsum(1) - counts + prior[:, None]
        expert.append(choice)
        slot.append(ahead.gather(0, choice[None])[0])
        gate.append(probs.gather(1, choice[:, None])[:, 0])
        frac = frac + counts.to(probs.dtype).mean(1)
        prior = prior + counts.sum(1)
        masked = masked.masked_fill(onehot.T, -torch.inf)
    expert, slot = torch.stack(expert), torch.stack(slot)
    aux = n_experts * torch.sum((frac / k) * probs.mean(0))
    return Routing(expert, slot, slot < capacity, torch.stack(gate), aux)


def router_dense(x: torch.Tensor, w_gate: torch.Tensor, *, k: int,
                 capacity: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's ``router``: ``(dispatch, combine, aux)`` with the (N, E, C)
    one-hot slot assignment and its gate-weighted copy."""
    n = x.shape[0]
    n_experts = w_gate.shape[-1]
    _check_k(k, n_experts)
    probs = _probs(x, w_gate)
    dtype = probs.dtype
    dispatch = torch.zeros((n, n_experts, capacity), dtype=dtype,
                           device=x.device)
    combine = torch.zeros_like(dispatch)
    prior = torch.zeros(n_experts, dtype=dtype, device=x.device)
    masked = probs
    frac = torch.zeros(n_experts, dtype=dtype, device=x.device)
    for _ in range(k):
        choice = masked.argmax(dim=-1)
        onehot = nn.functional.one_hot(choice, n_experts).to(dtype)
        gate = (probs * onehot).sum(-1)
        ahead = onehot.cumsum(0) - onehot + prior[None, :]
        pos = (ahead * onehot).sum(-1).long()
        # an out-of-capacity position is a zero row: the token drops out
        slot = (pos[:, None] == torch.arange(capacity, device=x.device)
                ).to(dtype)
        d = onehot[:, :, None] * slot[:, None, :]
        dispatch = dispatch + d
        combine = combine + gate[:, None, None] * d
        frac = frac + onehot.mean(0)
        prior = prior + onehot.sum(0)
        masked = torch.where(onehot > 0, -torch.inf, masked)
    aux = n_experts * torch.sum((frac / k) * probs.mean(0))
    return dispatch, combine, aux


def _experts(params: dict[str, torch.Tensor],
             expert_in: torch.Tensor) -> torch.Tensor:
    """The E expert MLPs on their (E, C, d) slots."""
    dtype = expert_in.dtype
    h = torch.relu(torch.bmm(expert_in, params["w1"].to(dtype))
                   + params["b1"].to(dtype)[:, None, :])
    return torch.bmm(h, params["w2"].to(dtype)) \
        + params["b2"].to(dtype)[:, None, :]


def moe_ffn(params: dict[str, torch.Tensor], x: torch.Tensor, *, k: int = 1,
            capacity_factor: float = 1.25
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on ``x`` (N, d) by indices: ``(y, aux)`` with ``y``
    (N, d) in ``x.dtype``, zero rows for dropped tokens.  ``params``:
    ``w_gate`` (d, E), ``w1`` (E, d, h), ``b1`` (E, h), ``w2`` (E, h, d),
    ``b2`` (E, d)."""
    n, d = x.shape
    n_experts = params["w1"].shape[0]
    capacity = expert_capacity(n, n_experts, capacity_factor)
    route = router(x, params["w_gate"], k=k, capacity=capacity)
    spare = n_experts * capacity  # the row that takes the dropped tokens
    rows = torch.where(route.keep, route.expert * capacity + route.slot,
                       spare)  # (k, N); kept rows are distinct
    xf = x.to(_acc_dtype(x))
    slots = xf.new_zeros((spare + 1, d))
    for r in rows:
        slots = slots.index_add(0, r, xf)
    out = _experts(params, slots[:spare].view(n_experts, capacity, d))
    out = torch.cat([out.reshape(spare, d), out.new_zeros((1, d))])
    # index_select, not out[r]: its backward is one index_add, where an
    # advanced index's sorts the rows and sums the spare row's many
    # duplicates one after another
    y = sum(g[:, None] * out.index_select(0, r)
            for g, r in zip(route.gate, rows))
    return y.to(x.dtype), route.aux


def moe_ffn_dense(params: dict[str, torch.Tensor], x: torch.Tensor, *,
                  k: int = 1, capacity_factor: float = 1.25
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_ffn` as JAX computes it, through the (N, E, C) one-hot
    dispatch and combine tensors: the plain version, O(N * E * C)
    memory."""
    n, _ = x.shape
    n_experts = params["w1"].shape[0]
    capacity = expert_capacity(n, n_experts, capacity_factor)
    dispatch, combine, aux = router_dense(x, params["w_gate"], k=k,
                                          capacity=capacity)
    xf = x.to(dispatch.dtype)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, xf)
    out = _experts(params, expert_in)
    y = torch.einsum("nec,ecd->nd", combine, out)
    return y.to(x.dtype), aux


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal of variance ``1 / fan_in``
    truncated at two standard deviations."""
    # 0.8796 is the std of a unit normal truncated at +-2
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class MoEMlp(nn.Module):
    """Tokens (B, N, d) -> ``(x + y, aux)``: the MoE FFN over all ``B * N``
    tokens with a residual that carries the dropped ones, and the
    router's auxiliary loss, which the caller adds to its training loss
    (JAX ``sow``s it into the ``losses`` collection)."""

    def __init__(self, channels: int, n_experts: int, hidden: int,
                 k: int = 1, capacity_factor: float = 1.25,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.k, self.capacity_factor = k, capacity_factor
        d, e, h = channels, n_experts, hidden
        self.w_gate = nn.Parameter(torch.empty(d, e))
        self.w1 = nn.Parameter(torch.empty(e, d, h))
        self.b1 = nn.Parameter(torch.empty(e, h))
        self.w2 = nn.Parameter(torch.empty(e, h, d))
        self.b2 = nn.Parameter(torch.empty(e, d))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        """flax's init on the stacked shapes: ``lecun_normal`` counts the
        expert axis into the fan-in (``w1`` (E, d, h) draws with variance
        1 / (E * d)); the biases 0."""
        with torch.no_grad():
            for w in (self.w_gate, self.w1, self.w2):
                fan_in = w.shape[-2] * math.prod(w.shape[:-2])
                lecun_normal_(w, fan_in, generator)
            self.b1.zero_()
            self.b2.zero_()

    def params(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def forward(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        b, n, d = x.shape
        y, aux = moe_ffn(self.params(), x.reshape(b * n, d), k=self.k,
                         capacity_factor=self.capacity_factor)
        return x + y.reshape(b, n, d), aux
