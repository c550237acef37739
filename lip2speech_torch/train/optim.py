"""The optimizer of the train step (PyTorch).

``AMSGrad`` is the counterpart of ``make_optimizer`` and its parts in
``lip2speech_tpu/train/train_step.py:66-176``, in the same order:

1. ``reject_above_norm``: a step whose raw global gradient norm exceeds
   ``reject_grad_norm_above`` (when > 0) is skipped;
2. ``skip_if_not_finite``: a step with a non-finite gradient is skipped,
   and the wrapper never gives up. A skipped step emits a zero update,
   leaves the moments and the count unchanged, and adds one to
   ``notfinite_count`` (consecutive skips) and ``total_notfinite``;
3. ``clip_by_global_norm(grad_clip)`` over the trainable gradients;
4. AMSGrad as optax 0.2.6 ``scale_by_amsgrad``: ``nu_max = max(nu_max,
   nu / (1 - b2^t))`` and the update ``(mu / (1 - b1^t)) / (sqrt(nu_max) +
   1e-8)``. ``torch.optim.AdamW(amsgrad=True)`` keeps the max of the raw
   second moments instead, which is another optimizer;
5. ``+ weight_decay * p`` on the trainable parameters;
6. ``* -learning_rate``.

Trainable parameters are those named ``encoder.*`` and ``decoder.*``; the
others (``vgg_face.*``) are frozen, get no decay and never move. An LSTM's
``bias_hh_*`` is not optimised either: the JAX package trains one folded
bias per LSTM layer, so the train state folds ``bias_hh`` into ``bias_ih``
(``fold_lstm_biases_``) and the optimizer moves ``bias_ih`` alone, as JAX
moves its bias (two biases under AMSGrad would move their sum by up to
twice the step). The
optimizer keeps its state as flat f32 vectors over the trainable
parameters, so a step is a few dozen elementwise kernels whatever the
number of tensors, and the skip is a select on the device (no host sync).
The update is added in place to the parameters themselves, which bumps
their version counters: caches keyed by tensor version (the AR kernel's
weight pack, ``Decoder._lstm_bias``) see the new weights.

Under tensor parallelism (``tp``, ``parallel.tensor.layout``) the flat
vectors hold this rank's shards of the sharded parameters, as
``opt_state_shardings`` gives the JAX moments their parameters' shardings.
The replicated entries of the gradient are taken as the model group's
first rank has them (its ranks compute them alike, but not always bit for
bit). The global norm is the replicated entries' square-sum plus the
sharded entries' square-sum summed over the model group, and the finite
check counts the non-finite entries over it too, so the clip, the skip and
the update agree on every rank. ``state_dict`` and ``load_state_dict`` keep
the one-rank layout (the shards gathered; a rank's slices cut).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from lip2speech_torch.config import TrainConfig
from lip2speech_torch.parallel import tensor
from lip2speech_torch.parallel.dist import agree_over_model_group_

TRAINABLE_TOP = ("encoder", "decoder")
B1, B2, EPS = 0.9, 0.999, 1e-8


def is_trainable(name: str) -> bool:
    """True for parameters under ``encoder.`` or ``decoder.``."""
    return name.split(".", 1)[0] in TRAINABLE_TOP


def is_optimised(name: str) -> bool:
    """Trainable, and not an LSTM's folded-away ``bias_hh``."""
    return is_trainable(name) and ".bias_hh_" not in name


@torch.no_grad()
def fold_lstm_biases_(model: torch.nn.Module) -> torch.nn.Module:
    """Every LSTM's ``bias_ih += bias_hh``, ``bias_hh = 0``, in place (the
    same function: the cell adds both)."""
    for m in model.modules():
        if isinstance(m, torch.nn.LSTM):
            for name, p in m.named_parameters():
                if name.startswith("bias_hh_"):
                    getattr(m, name.replace("bias_hh_", "bias_ih_")).add_(p)
                    p.zero_()
    return model


def all_finite(tensors) -> torch.Tensor:
    """0-d bool on the tensors' device: every entry of every tensor is
    finite (their max |x| is finite; a NaN makes it NaN)."""
    peaks = torch._foreach_norm(list(tensors), float("inf"))
    return torch.isfinite(torch.stack(peaks)).all()


class AMSGrad:
    """``make_optimizer``'s chain over ``named_params`` (name, parameter);
    ``tp`` = (the grid, the sharded names) of a tensor-parallel model."""

    def __init__(self, cfg: TrainConfig, named_params, tp=(None, ())):
        named = list(named_params)
        self.cfg = cfg
        self.names = [n for n, _ in named if is_optimised(n)]
        self.params = [p for n, p in named if is_optimised(n)]
        self.guarded = cfg.skip_nonfinite_updates or cfg.reject_grad_norm_above > 0.0
        dev = self.params[0].device
        self.tp, sharded = tp
        self.sharded = [n in sharded for n in self.names]
        # the flat vectors' entries that belong to a shard (None: no shards)
        self.shard_mask = None if not any(self.sharded) else torch.cat(
            [torch.full((p.numel(),), s, dtype=torch.bool, device=dev)
             for p, s in zip(self.params, self.sharded)])
        size = sum(p.numel() for p in self.params)
        self.mu = torch.zeros(size, device=dev)
        self.nu = torch.zeros(size, device=dev)
        self.nu_max = torch.zeros(size, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)

    def flatten(self, grads, dtype=torch.float32) -> torch.Tensor:
        """The trainable gradients as one vector of ``dtype`` (None: the
        gradients' own); a missing gradient counts as zeros."""
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for p, g in zip(self.params, grads)])
        return flat if dtype is None else flat.to(dtype)

    def norm_and_finite(self, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(the global norm of the flat gradient ``g``, 0-d bool: every entry
        finite, or None without shards, where ``accepts`` reads ``g``); under
        tensor parallelism both cover every rank's shards."""
        if self.shard_mask is None:
            return torch.sqrt(torch.sum(g * g)), None
        sq = g * g
        over_group = torch.stack([torch.sum(torch.where(self.shard_mask, sq, 0.0)),
                                  (~torch.isfinite(g)).sum().to(sq.dtype)])
        dist.all_reduce(over_group, group=self.tp.model_group)
        norm = torch.sqrt(torch.sum(torch.where(self.shard_mask, 0.0, sq)) + over_group[0])
        return norm, over_group[1] == 0

    def accepts(self, g: torch.Tensor, norm: torch.Tensor,
                finite: torch.Tensor | None = None) -> torch.Tensor:
        """0-d bool: the step is taken (steps 1 and 2 of the chain);
        ``finite`` is every entry's finiteness where ``g`` is a shard."""
        ok = torch.ones((), dtype=torch.bool, device=g.device)
        if self.guarded:
            ok = torch.isfinite(g).all() if finite is None else finite
        if self.cfg.reject_grad_norm_above > 0.0:
            ok = ok & (norm <= self.cfg.reject_grad_norm_above)
        return ok

    @torch.no_grad()
    def step(self, grads) -> dict[str, torch.Tensor]:
        """One update from the trainable gradients (in ``self.names``
        order, or already ``flatten``ed), written in place into the
        parameters. Returns ``ok`` (the step was taken), ``grad_norm``
        (global norm of the raw gradients) and, when guarded,
        ``notfinite_count``; all 0-d tensors."""
        cfg = self.cfg
        g = grads if torch.is_tensor(grads) else self.flatten(grads)
        if self.shard_mask is not None:
            # the replicated entries as the model group's first rank has them
            rep = g[~self.shard_mask]
            agree_over_model_group_([rep], self.tp)
            g = g.masked_scatter(~self.shard_mask, rep)
        norm, finite = self.norm_and_finite(g)
        ok = self.accepts(g, norm, finite)
        # clip_by_global_norm: select(norm < clip, g, g / norm * clip)
        g = torch.where(norm < cfg.grad_clip, g, g / norm * cfg.grad_clip)
        mu = (1 - B1) * g + B1 * self.mu
        nu = (1 - B2) * (g * g) + B2 * self.nu
        count = self.count + 1
        mu_hat = mu / (1 - torch.pow(torch.tensor(B1, device=g.device), count.float()))
        nu_hat = nu / (1 - torch.pow(torch.tensor(B2, device=g.device), count.float()))
        nu_max = torch.maximum(self.nu_max, nu_hat)
        p = torch.cat([x.reshape(-1) for x in self.params])
        u = (mu_hat / (torch.sqrt(nu_max) + EPS) + cfg.weight_decay * p) * -cfg.learning_rate
        if self.guarded:
            u = torch.where(ok, u, 0.0)
            mu, nu, nu_max = (torch.where(ok, new, old) for new, old in
                              ((mu, self.mu), (nu, self.nu), (nu_max, self.nu_max)))
            count = torch.where(ok, count, self.count)
            self.notfinite_count = torch.where(ok, 0, self.notfinite_count + 1).to(torch.int32)
            self.total_notfinite = self.total_notfinite + (~ok).to(torch.int32)
        self.mu, self.nu, self.nu_max, self.count = mu, nu, nu_max, count
        torch._foreach_add_(self.params, [x.view_as(q) for x, q in
                                          zip(u.split([q.numel() for q in self.params]), self.params)])
        out = {"ok": ok, "grad_norm": norm}
        if self.guarded:
            out["notfinite_count"] = self.notfinite_count
        return out

    MOMENTS = ("mu", "nu", "nu_max")

    def state_dict(self) -> dict:
        """The state in the one-rank layout: under tensor parallelism the
        moments' shards gathered over the model group (a collective)."""
        out = {"names": list(self.names), "count": self.count,
               "notfinite_count": self.notfinite_count, "total_notfinite": self.total_notfinite}
        for k in self.MOMENTS:
            v = getattr(self, k)
            out[k] = v if self.shard_mask is None else tensor.gather_flat(
                v, self.params, self.sharded, self.tp)
        return out

    def load_state_dict(self, state: dict):
        """Load a ``state_dict`` (one-rank layout); under tensor parallelism
        each moment as this rank's slices of it."""
        if list(state["names"]) != self.names:
            raise ValueError("optimizer state is for other parameters")
        for k in (*self.MOMENTS, "count", "notfinite_count", "total_notfinite"):
            v = state[k].to(getattr(self, k).device)
            if k in self.MOMENTS and self.shard_mask is not None:
                v = tensor.shard_flat(v, self.params, self.sharded, self.tp)
            setattr(self, k, v.clone())
