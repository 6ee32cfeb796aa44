"""Mixture-of-Experts layer, as the JAX package's ``nn/moe.py``.

Token-choice top-k routing (Switch/GShard): an f32 router picks each
token's k experts and renormalises their gates; tokens are routed within
fixed-size groups of ``g = min(group_size, tokens)`` tokens (the count
padded up to a group boundary), and each expert takes at most
``capacity = min(int(capacity_factor * k * g / E) or 1, g)`` tokens of a
group: a (token, choice)'s slot in its expert's buffer is the number of
earlier choices of that expert in the group (tokens in order, then
choices), and a choice past capacity is dropped (its gate counts for
nothing, so in a residual block the token passes through unchanged). The
experts are D -> hidden -> D MLPs over the groups' capacity slots;
the load-balance loss ``aux_loss_weight * E * sum_e frac_e * prob_e``
(``frac`` the share of first choices, ``prob`` the mean router
probability, over valid tokens) is the layer's state ``aux_loss``, and
``Model`` adds it to the objective.

The JAX layer builds one-hot dispatch and combine tensors and einsums
them; here the same slots are filled by index (each slot holds at most
one token, so the buffers are the same values; a dropped choice goes to
a spare row of its own, so no shape depends on the routing and nothing
waits for the host) and the combine sums each token's kept choices in
f32. Ties in the router's probabilities go to the lower expert index, as
``lax.top_k`` breaks them (a stable sort).

Under a data- or sequence-parallel strategy the JAX step routes the
GLOBAL batch: its groups run over the global token order, so a group may
span ranks. A rank holds rows ``[r0, r0 + b)`` and, under a sequence
split, positions ``[s0, s0 + t)`` of each (``Strategy.token_layout``), so
its token ``(i, j)`` is global token ``(r0 + i) * T + s0 + j``: each of
its rows is a segment of ``t`` consecutive tokens of the global order.
The capacity comes from the global group size; a token's slot adds to
the choices before it in its segment those of the earlier segments of
its group, from the per-(segment, group) counts of every rank, summed
over the batch group (one all-reduce of counts, which carry no
gradient); ``frac`` and ``prob`` are summed over the same group (one
all-reduce). The loss each rank differentiates is N times its share of
the global aux term (N the ranks of the batch group), whose value is the
global term, so the strategy's division of the summed gradients by N
gives the global term's gradient.

Under ``DataExpertParallel``, and ``CompositeParallel`` with an expert
axis (joined to model, seq, fsdp or pipe), the expert stacks are stored
as this rank's block of E/ep experts (role "expert", dim 0; under fsdp
that block's fsdp split, gathered where it is read): the tokens and the
gates go in through ``copy_to_group`` over the expert line, the rank's
experts run on their slots, and the partial combine is summed over the
line by ``reduce_from_group`` (Megatron's f/g pair). As in JAX, the
models that stack blocks (``scan=True``, ``pipeline=True``) take no MoE
block. ``decode`` routes each token without capacity, through every
expert (the leaves gathered where they are split).
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from . import activations, initializers
from .core import Layer, Shape, tp_layout
from ..parallel import collectives
from ..parallel.strategy import TokenLayout
from ..precision import resolve_dtype

_WEIGHTS = threading.local()


def current_sample_weights():
    """The ambient per-example validity weights (B,) that ``evaluate``
    publishes for a padded batch (JAX ``core.current_sample_weights``),
    or None."""
    return getattr(_WEIGHTS, "value", None)


class sample_weights:
    """Context: publish per-example weights to the layers whose
    statistics span the batch (the MoE's routing and aux loss), as the
    JAX ``eval_sample_weights``."""

    def __init__(self, weights):
        self.weights = weights

    def __enter__(self):
        self.prev = current_sample_weights()
        _WEIGHTS.value = self.weights
        return self.weights

    def __exit__(self, *exc):
        _WEIGHTS.value = self.prev


class MoE(Layer):
    """Token-choice top-k MoE over (B, T, D) or (B, D) inputs; the output
    has the input's shape. Parameters ``router`` (D, E) f32, ``w_in``
    (E, D, H), ``b_in`` (E, H), ``w_out`` (E, H, D), ``b_out`` (E, D), as
    the JAX layer's tree."""

    def __init__(self, num_experts: int, hidden_dim: int, *, top_k: int = 2,
                 capacity_factor: float = 1.25, group_size: int = 1024,
                 activation: str = "gelu", aux_loss_weight: float = 0.01,
                 dtype=None, name: Optional[str] = None):
        super().__init__(name)
        if top_k < 1 or top_k > num_experts:
            raise ValueError(
                f"top_k must be in [1, num_experts={num_experts}], got "
                f"{top_k}")
        self.num_experts = int(num_experts)
        self.hidden_dim = int(hidden_dim)
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.group_size = int(group_size)
        self.activation = activation
        self._act = activations.get(activation)
        self.aux_loss_weight = float(aux_loss_weight)
        self.dtype = dtype
        #: The last forward's aux term as the objective takes it (a
        #: differentiable scalar whose value is the global term), read by
        #: ``Model``; None before a forward.
        self.aux_term = None
        #: (kept, routed) choices of this rank's valid tokens in the last
        #: forward, a device tensor; None before one.
        self.routed = None

    def default_name(self) -> str:
        return "moe"  # the camel-case splitter would give "mo_e"

    def build(self, input_shape: Shape, generator):
        d = int(input_shape[-1])
        e, h = self.num_experts, self.hidden_dim
        glorot = initializers.get("glorot_uniform")
        self.router = torch.nn.Parameter(glorot(generator, (d, e)))
        self.w_in = torch.nn.Parameter(glorot(generator, (e, d, h)))
        self.b_in = torch.nn.Parameter(torch.zeros(e, h))
        self.w_out = torch.nn.Parameter(glorot(generator, (e, h, d)))
        self.b_out = torch.nn.Parameter(torch.zeros(e, d))
        # In the state from build on, so a fresh model and one that has
        # stepped have the same state tree (checkpoint restores compare).
        self.register_buffer("aux_loss", torch.zeros((), dtype=torch.float32))
        return tuple(input_shape)

    def sharding_hints(self):
        return {"w_in": "expert", "b_in": "expert", "w_out": "expert",
                "b_out": "expert"}

    def _capacity(self, group: int) -> int:
        c = int(self.capacity_factor * self.top_k * group
                / self.num_experts) or 1
        return min(c, group)

    def _route(self, tokens_f32, router):
        """Router probabilities (N, E) and the renormalised top-k gates
        and experts (N, k): the higher probability first, the lower
        expert index first among equal ones (``lax.top_k``'s order)."""
        probs = torch.softmax(tokens_f32 @ router.to(torch.float32), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[..., :self.top_k], idx[..., :self.top_k]
        vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
        return probs, vals, idx

    def _expert_line(self):
        """(layout of the expert stacks when this rank computes with its
        block of them, else None)."""
        return tp_layout(self, "w_in")

    def forward(self, x):
        from ..parallel.strategy import current_strategy

        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        b, t, d = x.shape
        n = b * t
        e, k = self.num_experts, self.top_k
        strategy = current_strategy()
        lay_t = None if strategy is None else strategy.token_layout(b, t)
        if lay_t is None or lay_t.shards == 1:
            strategy, lay_t = None, TokenLayout(b, t, 0, 0, 1)
        seq = lay_t.seq
        n_global = lay_t.rows * seq
        g = min(self.group_size, n_global)
        cap = self._capacity(g)
        dev = x.device
        # Each local row is a segment of t consecutive global tokens:
        # segment S = row * (T/t) + seq block, tokens [S*t, S*t + t).
        per_row = seq // t
        seg = ((lay_t.row_start + torch.arange(b, device=dev)) * per_row
               + lay_t.seq_offset // t)
        g0 = (lay_t.row_start * seq + lay_t.seq_offset) // g
        g1 = ((lay_t.row_start + b - 1) * seq + lay_t.seq_offset + t - 1) // g
        n_groups = g1 - g0 + 1

        flat = x.reshape(n, d)
        valid = torch.ones(n, dtype=torch.float32, device=dev)
        sw = current_sample_weights()
        if sw is not None:
            valid = ((sw > 0).to(torch.float32)[:, None]
                     .expand(b, t).reshape(n))
        probs, gates, gidx = self._route(flat.to(torch.float32),
                                         self._weight("router"))
        experts = torch.arange(e, device=dev)
        choice = ((gidx[..., None] == experts).to(torch.float32)
                  * valid[:, None, None])  # (n, k, e)

        # Each (token, choice)'s slot in its expert's group buffer: the
        # choices of that expert before it in its group, in the global
        # order (tokens, then choices). A piece is the part of a segment
        # in one group (at most m of them a segment); the counts of every
        # piece of the batch are summed over the batch group, so a token
        # finds the choices of the earlier segments of its group, on this
        # rank and on the others, then adds those before it in its piece.
        grp = (seg[:, None] * t + torch.arange(t, device=dev)) // g  # (b, t)
        m = (t - 1) // g + 2
        j = grp - ((seg * t) // g)[:, None]  # a token's piece in its segment
        piece = (torch.arange(b, device=dev)[:, None] * m + j).reshape(n)
        cf = choice.reshape(n * k, e)
        piece_k = piece.repeat_interleave(k)
        excl = torch.cumsum(cf, 0) - cf
        mine = torch.zeros(b * m, e, device=dev).index_add_(0, piece_k, cf)
        within = excl - (torch.cumsum(mine, 0) - mine)[piece_k]
        n_seg = lay_t.rows * per_row
        where = (seg[:, None] * m + torch.arange(m, device=dev)).reshape(-1)
        counts = torch.zeros(n_seg * m, e, device=dev).index_copy_(
            0, where, mine)
        if strategy is not None:
            counts = strategy.all_reduce_sum(counts)
        # Pieces in segment order are in global order, so the choices
        # before a piece in its group are the exclusive prefix over the
        # pieces less the totals of the earlier groups (a piece past its
        # segment's last group counts nothing; its group is clamped).
        n_all = -(-n_global // g)
        pg = ((torch.arange(n_seg, device=dev)[:, None] * t) // g
              + torch.arange(m, device=dev)).reshape(-1).clamp(max=n_all - 1)
        totals = torch.zeros(n_all, e, device=dev).index_add_(0, pg, counts)
        earlier = (torch.cumsum(counts, 0) - counts
                   - (torch.cumsum(totals, 0) - totals)[pg])
        pos = within + earlier[(seg[:, None] * m + j).reshape(n)
                               .repeat_interleave(k)]
        grp = grp.reshape(n)
        gid = grp - g0  # this rank's group index, for its buffers
        slot = (pos.reshape(n, k, e) * choice).sum(-1)  # (n, k)
        kept = (valid[:, None] > 0) & (slot < cap)

        # The expert buffers, (G, E_local, cap, D): this rank's experts.
        cd = resolve_dtype(self.dtype) or x.dtype
        w_in, b_in = self._weight("w_in"), self._weight("b_in")
        w_out, b_out = self._weight("w_out"), self._weight("b_out")
        lay = self._expert_line()
        e_loc = w_in.shape[0]
        e_lo = 0 if lay is None else lay.rank * e_loc
        tokens = flat.to(cd)
        if lay is not None:
            tokens = collectives.copy_to_group(tokens, lay.group)
            gates = collectives.copy_to_group(gates, lay.group)
        # Every (token, choice) has a row of its own: its slot when it is
        # kept and its expert is this rank's, else a spare row past the
        # buffers (read back as zeros). No shape depends on the routing,
        # and no two choices share a row (a shared spare row would
        # serialize the gather's backward on its one address).
        local = gidx - e_lo
        sel = kept & (local >= 0) & (local < e_loc)
        # The buffers are expert-major, (E_local, G * cap, D): each
        # expert's slots of every group go through one batched product.
        size = e_loc * n_groups * cap
        spare = size + torch.arange(n * self.top_k, device=dev).view(
            n, self.top_k)
        dest = torch.where(
            sel, (local.clamp(0, e_loc - 1) * n_groups + gid[:, None]) * cap
            + slot.to(torch.int64).clamp(max=cap - 1), spare).reshape(-1)
        src = tokens[:, None].expand(n, self.top_k, d).reshape(-1, d)
        buf = torch.zeros(size + n * self.top_k, d, dtype=cd,
                          device=dev).index_copy(0, dest, src)[:size]
        buf = buf.view(e_loc, n_groups * cap, d)
        hid = self._act(torch.baddbmm(b_in.to(cd)[:, None], buf,
                                      w_in.to(cd)))
        out_buf = torch.baddbmm(b_out.to(cd)[:, None], hid, w_out.to(cd))
        rows_out = torch.cat([out_buf.reshape(size, d),
                              out_buf.new_zeros(n * self.top_k, d)])
        picked = rows_out[dest].to(torch.float32).view(n, self.top_k, d)
        out = (picked * (gates * sel)[..., None]).sum(1)
        if lay is not None:
            out = collectives.reduce_from_group(out, lay.group)

        # (kept choices, valid choices) of this rank's tokens, on the
        # device: the share of dropped tokens, read without a sync.
        self.routed = torch.stack([kept.sum().to(torch.float32),
                                   choice.sum().detach()])
        self._aux(probs, choice, valid, lay_t.shards, strategy)
        out = out.to(cd).reshape(b, t, d).to(x.dtype)
        return out[:, 0] if squeeze else out

    def _aux(self, probs, choice, valid, shards, strategy):
        """The load-balance term over the valid tokens of the global batch
        (``aux_term``; the state ``aux_loss`` holds its value after a
        training forward)."""
        e = self.num_experts
        frac = choice[:, 0].sum(0)
        prob = (probs * valid[:, None]).sum(0)
        n_valid = valid.sum()
        if strategy is not None:
            stats = strategy.all_reduce_sum(torch.cat(
                [frac, prob.detach(), n_valid[None]]))
            frac_g, prob_g, nv = stats[:e], stats[e:2 * e], stats[2 * e]
        else:
            frac_g, prob_g, nv = frac, prob.detach(), n_valid
        nv = torch.clamp_min(nv, 1.0)
        scale = self.aux_loss_weight * e
        value = scale * torch.sum((frac_g / nv) * (prob_g / nv))
        # N times this rank's share (N the batch group's ranks); its value
        # replaced by the global term's (the share's gradient, the global
        # value).
        term = scale * torch.sum((frac_g / nv) * (prob * shards / nv))
        self.aux_term = term + (value - term).detach()
        if self.training:
            with torch.no_grad():
                self.aux_loss.copy_(value.detach())

    # ------------------------------------------------- incremental decode
    # The forward mixes positions through the groups' capacity; one
    # token routes without it, through every expert (dropless), which is
    # the forward's result whenever the forward dropped nothing.
    decode_safe = True

    def decode(self, cache, x, *, pos):
        b, t, d = x.shape
        e = self.num_experts
        flat = x.reshape(b * t, d)
        _, gates, gidx = self._route(flat.to(torch.float32),
                                     self._weight("router"))
        onehot = (gidx[..., None] == torch.arange(e, device=x.device)).to(
            torch.float32)
        weight = torch.einsum("nk,nke->ne", gates, onehot)
        cd = resolve_dtype(self.dtype) or x.dtype
        h = self._act(
            torch.einsum("nd,edh->neh", flat.to(cd),
                         self._weight("w_in").to(cd))
            + self._weight("b_in").to(cd)[None])
        out_e = (torch.einsum("neh,ehd->ned", h, self._weight("w_out").to(cd))
                 + self._weight("b_out").to(cd)[None])
        out = torch.einsum("ne,ned->nd", weight.to(cd), out_e)
        return out.reshape(b, t, d).to(x.dtype), cache

    def paged_decode(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        # The JAX default: the one-token decode, dropless.
        return self.decode({}, x, pos=positions)[0], cache


def aux_terms(module):
    """The aux terms the last forward of ``module`` left (one per MoE
    layer in it), for the objective (the JAX ``_aux_loss_sum``)."""
    return [m.aux_term for m in module.modules()
            if isinstance(m, MoE) and m.aux_term is not None]


def has_moe(module) -> bool:
    return any(isinstance(m, MoE) for m in module.modules())


__all__ = ["MoE", "aux_terms", "current_sample_weights",
           "has_moe", "sample_weights"]
