"""The MobileQuant optimization loops (the port of mobilequant_tpu/quant/train.py):
e2equant (joint, end to end) and omniquant (layer by layer), then finalize.

LET, LWC and LRL (the learned static ranges) are trained against the FP
teacher's hidden states before the final norm, with torch autograd through
the fake-quant sim (quant/qmodel.py):
  * three AdamW param groups, "let" / "lwc" / "ranges", each with its own
    cosine-decayed learning rate and linear warmup (_cosine_lr: the JAX
    schedule's fp32 arithmetic, as a LambdaLR multiplier), betas (0.9,
    0.999), eps 1e-8, no weight decay; grad_clip clips each group's global
    norm on its own (optax.clip_by_global_norm's rule, per group, as
    optax.chain clips each group's tree);
  * every trainable leaf takes a gradient each step (zeros where the loss
    does not reach it), as optax updates every leaf;
  * the teacher runs once under torch.no_grad() and its hiddens stay on the
    device up to TrainConfig.teacher_cache_bytes;
  * a non-finite loss raises FloatingPointError.
Pipeline-parallel training (the JAX e2equant's pp_mesh) is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from mobilequant_tpu_torch.models import model as M
from mobilequant_tpu_torch.models.config import ModelConfig
from mobilequant_tpu_torch.quant import qmodel, smooth
from mobilequant_tpu_torch.quant.policy import QPolicy
from mobilequant_tpu_torch.quant.quantizer import clip_weight_to_learned_bounds

GROUPS = ("let", "lwc", "ranges")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 60
    batch_size: int = 1
    let_lr: float = 1e-3
    let_min_lr: float = 1e-4
    lwc_lr: float = 1e-2
    lwc_min_lr: float = 1e-3
    lrl_lr: float = 1e-6
    lrl_min_lr: float = 1e-7
    warmup_frac: float = 0.0
    use_let: bool = True
    use_lwc: bool = True
    use_lrl: bool = True
    aug_loss: bool = False         # a second MSE against the FP layer applied
                                   # to the quantized input stream; in the e2e
                                   # loop both streams start from the same
                                   # embedding, so the term doubles the loss
                                   # (as in the reference)
    grad_clip: Optional[float] = None
    log_every: int = 50
    remat: bool = False            # recompute layers on the backward pass
    infer_batch: Optional[int] = None  # batch of the passes without
                                   # gradients (teacher, propagation); default
                                   # max(batch_size, 16)
    teacher_cache_bytes: int = 4 << 30  # teacher hiddens kept on the device
                                   # up to this many bytes, on the host past it


def _cosine_lr(max_lr, min_lr, warmup_iters, max_iters):
    """step -> learning rate: linear warmup to max_lr, then cosine decay to
    min_lr at max_iters, in fp32 as the JAX schedule computes it."""
    f = np.float32

    def schedule(step):
        s = f(step)
        if s < warmup_iters:
            return float(f(max_lr) * s / f(max(warmup_iters, 1)))
        ratio = (s - f(warmup_iters)) / f(max(max_iters - warmup_iters, 1))
        ratio = min(max(ratio, f(0.0)), f(1.0))
        coeff = f(0.5) * (f(1.0) + np.cos(f(np.pi) * ratio))
        return float(f(min_lr) + coeff * f(max_lr - min_lr))
    return schedule


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _trainable(tree):
    return _map(lambda t: t.detach().clone().requires_grad_(True), tree)


def _detached(tree):
    return _map(lambda t: t.detach().clone(), tree)


class _Optimizer:
    """AdamW over the "let" / "lwc" / "ranges" groups of `trainable`, each on
    its cosine schedule, with the optional per-group norm clip."""

    def __init__(self, tc: TrainConfig, trainable: dict, total_steps: int):
        warmup = int(tc.warmup_frac * total_steps)
        lrs = {"let": (tc.let_lr, tc.let_min_lr), "lwc": (tc.lwc_lr, tc.lwc_min_lr),
               "ranges": (tc.lrl_lr, tc.lrl_min_lr)}
        groups, mults = [], []
        for k in trainable:
            max_lr, min_lr = lrs[k]
            sched = _cosine_lr(max_lr, min_lr, warmup, total_steps)
            groups.append({"params": _leaves(trainable[k]), "lr": max_lr})
            mults.append(lambda step, s=sched, m=max_lr: s(step) / m if m else 0.0)
        self.params = [p for g in groups for p in g["params"]]
        self.opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
        self.sched = torch.optim.lr_scheduler.LambdaLR(self.opt, mults)
        self.grad_clip = tc.grad_clip

    def step(self, loss: torch.Tensor) -> float:
        """One update from loss; -> the global gradient norm (all groups)."""
        grads = torch.autograd.grad(loss, self.params, allow_unused=True,
                                    materialize_grads=True)
        for p, g in zip(self.params, grads):
            p.grad = g
        gnorm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads])))
        if self.grad_clip is not None:
            for g in self.opt.param_groups:
                # optax.clip_by_global_norm's rule: scale by clip / norm when
                # the norm exceeds it (clip_grad_norm_ adds 1e-6 to the norm,
                # 0.2% of a 6e-4 group norm)
                ps = g["params"]
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(p.grad) for p in ps]))
                if float(norm) > self.grad_clip:
                    torch._foreach_mul_([p.grad for p in ps], self.grad_clip / norm)
        self.opt.step()
        self.sched.step()
        return gnorm


def init_qstate(params, config: ModelConfig, policy: QPolicy, tc: TrainConfig,
                ranges: dict, let: Optional[dict] = None, device="cuda") -> dict:
    """The trainable quant state: LET (let, e.g. from the SmoothQuant init,
    else identity), LWC (init 4.0) and the calibrated ranges (trained when
    tc.use_lrl). The leaves it makes go on `device`."""
    qstate = {}
    if tc.use_let:
        qstate["let"] = let if let is not None else smooth.let_init(config, device=device)
    if tc.use_lwc:
        qstate["lwc"] = _map(lambda t: t.to(device), qmodel.lwc_init_all(params, policy))
    qstate["ranges"] = ranges
    return qstate


def e2e_loss(params, qstate, tokens, fp_hidden, config: ModelConfig, policy: QPolicy,
             tc: TrainConfig) -> torch.Tensor:
    """MSE between the sim's and the teacher's hiddens before the final norm
    (doubled under aug_loss: the e2e loop's aug teacher is the teacher)."""
    qh, _, _ = qmodel.qforward_hidden(params, qstate, tokens, config, policy,
                                      apply_final_norm=False, remat=tc.remat)
    loss = torch.mean(torch.square(qh - fp_hidden))
    if tc.aug_loss:
        loss = loss + torch.mean(torch.square(qh - fp_hidden))
    return loss


def _split(qstate: dict, tc: TrainConfig):
    keys = [k for k in GROUPS if k in qstate and (k != "ranges" or tc.use_lrl)]
    return keys, {k: v for k, v in qstate.items() if k not in keys}


def e2equant(params, qstate, tokens: np.ndarray, config: ModelConfig, policy: QPolicy,
             tc: TrainConfig = TrainConfig(), logger=None,
             checkpoint_cb: Optional[Callable[[int, dict], None]] = None):
    """Joint end-to-end training of LET + LWC + LRL against the FP teacher's
    hiddens, on the params' device. tokens: (N, T) calibration sequences.
    checkpoint_cb(epoch, qstate) after every epoch. -> (qstate, the mean loss
    of every epoch)."""
    dev = params["embed"]["w"].device
    qmodel.require_fp32_matmuls(dev)
    n = tokens.shape[0]
    total_steps = tc.epochs * max(n // tc.batch_size, 1)
    keys, static = _split(qstate, tc)
    trainable = {k: _trainable(qstate[k]) for k in keys}
    opt = _Optimizer(tc, trainable, total_steps)

    tok_batches = [torch.as_tensor(np.asarray(tokens[i:i + tc.batch_size]), device=dev)
                   .to(torch.long) for i in range(0, n, tc.batch_size)]
    on_device = n * tokens.shape[1] * config.hidden_size * 4 <= tc.teacher_cache_bytes
    fp_hidden = []
    with torch.no_grad():
        for tok in tok_batches:
            h, _, _ = M.forward_hidden(params, tok, config, apply_final_norm=False)
            fp_hidden.append(h if on_device else h.cpu())

    history = []
    for epoch in range(tc.epochs):
        losses, gnorm = [], 0.0
        for bi, tok in enumerate(tok_batches):
            loss = e2e_loss(params, {**static, **trainable}, tok, fp_hidden[bi].to(dev),
                            config, policy, tc)
            gnorm = opt.step(loss)
            loss = float(loss.detach())
            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at epoch {epoch} step {bi}")
            losses.append(loss)
        history.append(float(np.mean(losses)))
        if logger is not None:
            logger.info(f"[e2equant] epoch {epoch + 1}/{tc.epochs} "
                        f"loss {history[-1]:.6e} grad_norm {gnorm:.3e}")
        if checkpoint_cb is not None:
            checkpoint_cb(epoch, {**static, **_detached(trainable)})
    return {**static, **_detached(trainable)}, history


@torch.no_grad()
def finalize(params, qstate, config: ModelConfig, policy: QPolicy):
    """LET folded into the weights (scales truncated first) and the weights
    clamped into their learned LWC bounds. -> (params', {"ranges": the
    learned ranges}); LET and LWC are spent."""
    let = qstate.get("let")
    if let is not None:
        let = {k: (smooth.truncate_scale(v) if k.endswith("scale") else v)
               for k, v in let.items()}
        params = smooth.fold_let(params, let, config)
    lwc = qstate.get("lwc")
    if lwc is not None:
        layers = dict(params["layers"])
        for site, bounds in lwc.items():
            pkey = qmodel.SITE_TO_PARAM[site]
            wq = policy[site].weight
            w = layers[pkey]["w"]
            layers[pkey] = {**layers[pkey], "w": torch.stack([
                clip_weight_to_learned_bounds(w[l], wq, {"up": bounds["up"][l],
                                                         "low": bounds["low"][l]})
                for l in range(w.shape[0])])}
        params = {**params, "layers": layers}
    return params, {"ranges": qstate["ranges"]}


# ---------------------------------------------------------------------------
# Layer by layer (OmniQuant-style)
# ---------------------------------------------------------------------------

def omniquant(params, qstate, tokens: np.ndarray, config: ModelConfig, policy: QPolicy,
              tc: TrainConfig = TrainConfig(), logger=None,
              checkpoint_cb: Optional[Callable[[int, dict], None]] = None,
              resume_state: Optional[dict] = None, resume_layers: int = 0):
    """Each layer's quant params trained against that layer's FP outputs,
    then the quantized activations propagate to the next layer.

    checkpoint_cb(layer, qstate) after every trained layer. resume_state /
    resume_layers: the first resume_layers layers take their trained state
    from resume_state and skip training; propagation re-runs for them, so the
    final state equals an uninterrupted run's bit for bit. -> (qstate, None)."""
    c = config
    dev = params["embed"]["w"].device
    qmodel.require_fp32_matmuls(dev)
    n, T = tokens.shape
    total_steps = tc.epochs * max(n // tc.batch_size, 1)
    tok_all = torch.as_tensor(np.asarray(tokens), device=dev).to(torch.long)
    pos = torch.arange(T, device=dev)[None].expand(n, T)

    def layer_apply(lp, extras, x, quantized: bool):
        p = pos[:x.shape[0]]
        cos, sin = M.rope_cos_sin(p, c, x.dtype)
        mask = M.causal_mask(p, T, c.neg_inf).to(x.dtype)
        ops = qmodel.QuantOps(policy, c, "sim") if quantized else M.Ops()
        ops.begin_layer(extras)
        out, _ = M.decoder_layer(ops, lp, x, cos, sin, mask, c)
        return out

    # the passes without gradients run at infer_batch; their buffers stay on
    # the device when the three (n, T, D) of them fit in teacher_cache_bytes
    ib = tc.infer_batch or max(tc.batch_size, 16)
    store = dev if 3 * n * T * c.hidden_size * 4 <= tc.teacher_cache_bytes else "cpu"

    @torch.no_grad()
    def batched(fn, x):
        return torch.cat([fn(x[i:i + ib].to(dev)).to(store) for i in range(0, n, ib)])

    def embed(tok):
        x = params["embed"]["w"][tok]
        if c.normalize_embed:
            x = x * torch.tensor(math.sqrt(c.hidden_size), dtype=x.dtype)
        return x

    fp_inps = batched(embed, tok_all)
    quant_inps = fp_inps

    keys, _ = _split(qstate, tc)
    if resume_state is None:
        resume_layers = 0
    resume_layers = min(resume_layers, c.num_layers)
    final_state = _detached(resume_state if resume_layers > 0 else qstate)

    for li in range(c.num_layers):
        lp = M._layer_slice(params["layers"], li)
        src = final_state if li < resume_layers else qstate
        layer_state = {k: M._layer_slice(v, li) for k, v in src.items()}
        static = {k: v for k, v in layer_state.items() if k not in keys}

        fp_out = batched(lambda x: layer_apply(lp, None, x, False), fp_inps)
        # the aug teacher: the FP layer on the quantized input stream
        fp_out2 = (batched(lambda x: layer_apply(lp, None, x, False), quant_inps)
                   if tc.aug_loss else fp_out)

        if li < resume_layers:
            merged = layer_state
            if logger is not None:
                logger.info(f"[omniquant] layer {li} resumed (training skipped)")
        else:
            trainable = {k: _trainable(layer_state[k]) for k in keys}
            opt = _Optimizer(tc, trainable, total_steps)
            last = None
            for _ in range(tc.epochs):
                for i in range(0, n, tc.batch_size):
                    sl = slice(i, i + tc.batch_size)
                    out = layer_apply(lp, {**static, **trainable}, quant_inps[sl].to(dev), True)
                    loss = torch.mean(torch.square(out - fp_out[sl].to(dev)))
                    if tc.aug_loss:
                        loss = loss + torch.mean(torch.square(out - fp_out2[sl].to(dev)))
                    opt.step(loss)
                    last = float(loss.detach())
                    if not math.isfinite(last):
                        raise FloatingPointError(f"non-finite loss, layer {li}")
            if logger is not None:
                logger.info(f"[omniquant] layer {li} final loss {last:.6e}")
            merged = {**static, **_detached(trainable)}
            for k, tree in merged.items():
                for full, one in zip(_leaves(final_state[k]), _leaves(tree)):
                    full[li] = one
            if checkpoint_cb is not None:
                checkpoint_cb(li, _detached(final_state))

        quant_inps = batched(lambda x: layer_apply(lp, merged, x, True), quant_inps)
        fp_inps = fp_out
    return final_state, None
