"""AdaRound PTQ reconstruction (port of `viditq_tpu/quant/reconstruction.py`).

Reference: `qdiff/optimization/{layer_recon,block_recon,model_recon}.py`
and `LossFunction`/`LinearTempDecay` (`qdiff/utils.py:94-200`), live in the
t2i flow (`t2i/scripts/ptq.py:320-395`). The optimisation minimises

    || act_q(x) @ soft_quant(w) + b  -  y_fp ||^2
  + lambda * sum(1 - |2*h(alpha) - 1|^b)          (after warmup; b: 10 -> 2)

over the AdaRound logits `alpha` (and optionally the act step size) with
Adam (`torch.optim.Adam`, one parameter group per learning rate, as
`optax.multi_transform`; its update is optax's, eps outside the square
root, with another order of the float operations) on minibatches of
captured I/O.

Granularities, as in the JAX package:
  * layer (`model_reconstruction`): each quantized linear against its own
    fp output, on the fp inputs `capture_layer_io` collects in one forward
    (every layer's I/O held at once); the kv linear is skipped, and a
    channel-balancing layer learns its rounding on the folded weight
    kernel * cs[0] (timerange 0's scale) with its input divided by cs[0];
  * the MLP pair (`mlp_block_reconstruction`): fc1 and fc2 jointly through
    the tanh-GELU;
  * block (`model_block_reconstruction`): every AdaRound layer of one
    transformer block jointly against the block's fp output, the block run
    in float32 (`standalone_block`: on the card K3's float32 mode forward,
    the plain f32 attention backward) with soft targets; with `asym` each
    block's input is re-captured in quant mode (hard rounding) through the
    already reconstructed blocks before it.

Capture is forward hooks on the port's modules where the JAX package sows
into 'intermediates': a quantized linear's first call (`capture_layer_io`)
and a block's first call, its input, output and shared context y and t0
(`capture_block_io`). The minibatch indices come from an explicit CPU
`torch.Generator` (one per layer or block, seeded from `seed` and its
index, as JAX folds the index into its key); no global RNG is read. They
cannot match JAX's threefry draws, so the port agrees with the JAX package
where a draw cannot matter (a batch of one row, or rows that repeat).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from viditq_tpu_torch.models.layers import approx_gelu
from viditq_tpu_torch.quant import core
from viditq_tpu_torch.quant.naming import pattern_in
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
from viditq_tpu_torch.quant.spec import LayerQuantSpec


def temp_decay(t: int, t_max: int, warmup: float = 0.0,
               start_b: float = 10.0, end_b: float = 2.0) -> torch.Tensor:
    """LinearTempDecay (qdiff/utils.py:187-200), in float32 as JAX takes
    it: b falls linearly from start_b to end_b after the warmup."""
    start = warmup * t_max
    tt = torch.tensor(float(t), dtype=torch.float32)
    rel = torch.clamp((tt - start) / max(t_max - start, 1), 0.0, 1.0)
    return end_b + (start_b - end_b) * torch.clamp(1.0 - rel, min=0.0)


@dataclasses.dataclass
class ReconConfig:
    iters: int = 2000
    batch_size: int = 32
    lr_alpha: float = 1e-3       # AdaRound logits
    lr_delta: float = 4e-5       # act step size (when opt_target includes act)
    lambda_coeff: float = 1.0    # round-loss weight (utils.py:101)
    b_range: Tuple[float, float] = (10.0, 2.0)
    warmup: float = 0.0
    opt_target: str = "weight"   # 'weight' | 'weight_and_activation'


def recon_config(plan) -> ReconConfig:
    """The ReconConfig of a plan's weight optimisation section, as the JAX
    CLI builds it (cli.py:246-253)."""
    wopt = plan.weight_opt
    return ReconConfig(
        iters=wopt.iters, batch_size=plan.calib_batch_size,
        lr_alpha=wopt.alpha_lr or 1e-3, lr_delta=wopt.delta_lr or 4e-5,
        lambda_coeff=wopt.lambda_coeff, warmup=wopt.warmup,
        opt_target=("weight_and_activation" if wopt.joint_weight_act
                    else "weight"))


def wants_reconstruction(plan) -> bool:
    """The reference's use_optimization gate (t2i/scripts/ptq.py:320-359;
    JAX cli.py:243-245): the YAML's `quant.weight.optimization.params` and
    AdaRound rounding."""
    wopt, wspec = plan.weight_opt, plan.default_layer.weight
    return (wopt is not None and wopt.enabled and wspec is not None
            and wspec.round_mode == "learned_hard_sigmoid")


def generator(seed: int, index: int) -> torch.Generator:
    """The CPU generator of the minibatch draws of layer or block `index`
    (JAX `fold_in(rng, index)`)."""
    state = np.random.SeedSequence([seed, index]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def _draw(g: torch.Generator, n: int, bs: int, device) -> torch.Tensor:
    return torch.randint(0, n, (bs,), generator=g).to(device)


def round_loss(alphas: Sequence[torch.Tensor], t: int,
               cfg: ReconConfig):
    """lambda * sum over alphas of (1 - |2 h(alpha) - 1|^b), b from
    `temp_decay`; 0 before the warmup's end (qdiff/utils.py:169-176)."""
    if t < cfg.warmup * cfg.iters:
        return 0.0
    b = temp_decay(t, cfg.iters, cfg.warmup, *cfg.b_range)
    return cfg.lambda_coeff * sum(
        torch.sum(1.0 - torch.abs(2.0 * core.adaround_soft_targets(a) - 1.0)
                  ** b) for a in alphas)


def _soft_weight(kernel, floor, alpha, delta, zp, wspec):
    """The weight at AdaRound's soft rounding: floor(w / delta) + h(alpha),
    clipped to the spec's code range and dequantized."""
    n_levels = wspec.n_levels()
    soft = core.adaround_soft_targets(alpha)
    if wspec.sym:
        # signed sym codes clamp to [-2^(b-1), 2^(b-1)-1] (fake_quant's)
        return core.clip(floor + soft, -n_levels - 1, n_levels) * delta
    code = core.clip(floor + soft + zp, 0, n_levels - 1)
    return (code - zp) * delta


def layer_reconstruction(kernel: torch.Tensor, bias: Optional[torch.Tensor],
                         x_fp: torch.Tensor, y_fp: torch.Tensor,
                         lspec: LayerQuantSpec,
                         cfg: ReconConfig = ReconConfig(),
                         gen: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
    """Optimise AdaRound alpha (and optionally the act step size) of one
    layer (JAX reconstruction.py:47-150). kernel [C_in, F]; x_fp [..., C_in]
    captured inputs; y_fp the matching fp outputs. Returns {'w_alpha',
    'w_delta', 'w_zp', 'recon_losses'[, 'a_delta']}."""
    wspec, aspec = lspec.weight, lspec.act
    gen = gen if gen is not None else generator(0, 0)
    kernel = kernel.detach().float()
    x2 = x_fp.reshape(-1, x_fp.shape[-1]).float()
    y2 = y_fp.reshape(-1, y_fp.shape[-1]).float()
    n = x2.shape[0]
    bs = min(cfg.batch_size, n)
    bias = None if bias is None else bias.detach().float()

    w_delta, w_zp = core.compute_qparams(kernel, wspec)
    floor = torch.floor(kernel / w_delta)
    alpha = core.adaround_init_alpha(kernel, w_delta).requires_grad_()
    groups = [{"params": [alpha], "lr": cfg.lr_alpha}]
    opt_act = (cfg.opt_target == "weight_and_activation"
               and aspec is not None and not aspec.dynamic)
    a_opt_spec, a_delta, a_zp0 = aspec, None, None
    if opt_act:
        if aspec.granularity == "token":
            # one step size for the layer: a per-token delta over all the
            # captured rows cannot be indexed per minibatch
            # (reconstruction.py:80-90)
            a_opt_spec = dataclasses.replace(aspec, granularity="tensor")
        a_delta, a_zp0 = core.compute_qparams(x2[None], a_opt_spec)
        a_delta.requires_grad_()
        groups.append({"params": [a_delta], "lr": cfg.lr_delta})
    opt = torch.optim.Adam(groups)

    def act_q(x):
        if aspec is None or not lspec.act_quant:
            return x
        if aspec.dynamic:
            return core.fake_quant_dynamic(x[None], aspec)[0]
        if opt_act:  # the learned step size, the zero point as initialised
            return core.fake_quant(x[None], a_delta, a_zp0, a_opt_spec)[0]
        d, z = core.compute_qparams(x[None], aspec)
        return core.fake_quant(x[None], d, z, aspec)[0]

    losses = []
    with torch.enable_grad():
        for t in range(cfg.iters):
            idx = _draw(gen, n, bs, x2.device)
            pred = act_q(x2[idx]) @ _soft_weight(kernel, floor, alpha,
                                                 w_delta, w_zp, wspec)
            if bias is not None:
                pred = pred + bias
            loss = (torch.mean((pred - y2[idx]) ** 2)
                    + round_loss((alpha,), t, cfg))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    out = {"w_alpha": alpha.detach(), "w_delta": w_delta, "w_zp": w_zp,
           "recon_losses": torch.stack(losses) if losses else None}
    if opt_act:
        out["a_delta"] = a_delta.detach()
    return out


def capture_layer_io(model: nn.Module, example_args, mode: str = "fp"
                     ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{dotted layer name: (input, output)} of every quantized linear's
    first call in one forward (JAX reconstruction.py:262-277; the
    reference's save_in_out_data hooks, qdiff/utils.py:228)."""
    names = {m: n for n, m in model.named_modules()
             if isinstance(m, QuantLinear) and m.path is not None}
    out: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def hook(mod, args, output):
        name = names[mod]
        if name not in out and args and args[0] is not None:
            out[name] = (args[0].detach(), output.detach())
    handles = [m.register_forward_hook(hook) for m in names]
    try:
        with torch.no_grad():
            model(*example_args, qctx=QuantCtx(mode=mode, capture=True))
    finally:
        for h in handles:
            h.remove()
    return out


def model_reconstruction(model: nn.Module,
                         layer_io: Dict[str, Tuple[torch.Tensor,
                                                   torch.Tensor]],
                         cfg: ReconConfig = ReconConfig(),
                         skip_patterns: Tuple[str, ...] = ("kv_linear",),
                         seed: int = 0) -> nn.Module:
    """Layer reconstruction of every captured AdaRound layer, its
    optimised w_alpha and its timerange-0 w_delta/w_zp of the active
    bitwidth written into the model (JAX reconstruction.py:153-206; the
    reference model_recon.py:38-52 skips fp layers and the kv linear).
    layer_io: `capture_layer_io` in fp mode."""
    mods = dict(model.named_modules())
    for i, (name, (x_fp, y_fp)) in enumerate(sorted(layer_io.items())):
        mod = mods.get(name)
        if not isinstance(mod, QuantLinear) or not mod.adaround:
            continue
        if any(pattern_in(name, p) for p in skip_patterns):
            continue
        lspec = mod.lspec
        kernel = mod.kernel.detach().float()
        if lspec.smooth_quant.enable and hasattr(mod, "cb_scale"):
            # learn the rounding on the folded weight kernel * cs[0], the
            # lattice the packing rounds on (reconstruction.py:180-195)
            cs = mod.cb_scale[0]
            cs0 = torch.where(cs > 0, cs, torch.ones_like(cs)).float()
            kernel = kernel * cs0[:, None]
            x_fp = x_fp.float() / cs0
        res = layer_reconstruction(kernel, mod.bias, x_fp, y_fp, lspec, cfg,
                                   generator(seed, i))
        bi = lspec.weight.bit_idx
        with torch.no_grad():
            mod.w_alpha.copy_(res["w_alpha"])
            mod.w_delta[bi, 0] = res["w_delta"]
            mod.w_zp[bi, 0] = res["w_zp"]
    return model


def mlp_block_reconstruction(fc1_kernel, fc1_bias, fc2_kernel, fc2_bias,
                             x_fp: torch.Tensor, y_fp: torch.Tensor,
                             lspec: LayerQuantSpec,
                             cfg: ReconConfig = ReconConfig(),
                             gen: Optional[torch.Generator] = None) -> Dict:
    """Both MLP linears' rounding jointly against the MLP's fp output
    through the tanh-GELU (JAX reconstruction.py:209-259; reference
    block_recon.py:31, the round loss summed over the block's layers).
    x_fp: captured fc1 inputs; y_fp: fc2's fp outputs. Returns {'fc1':
    {'w_alpha', 'w_delta', 'w_zp'}, 'fc2': {...}, 'recon_losses'}."""
    wspec, aspec = lspec.weight, lspec.act
    gen = gen if gen is not None else generator(0, 0)
    x2 = x_fp.reshape(-1, x_fp.shape[-1]).float()
    y2 = y_fp.reshape(-1, y_fp.shape[-1]).float()
    n = x2.shape[0]
    bs = min(cfg.batch_size, n)
    layers = {}
    for name, k in (("fc1", fc1_kernel), ("fc2", fc2_kernel)):
        k = k.detach().float()
        d, z = core.compute_qparams(k, wspec)
        layers[name] = {"kernel": k, "delta": d, "zp": z,
                        "floor": torch.floor(k / d),
                        "alpha": core.adaround_init_alpha(k, d)
                        .requires_grad_()}
    biases = {name: None if b is None else b.detach().float()
              for name, b in (("fc1", fc1_bias), ("fc2", fc2_bias))}
    alphas = [layers[nm]["alpha"] for nm in ("fc1", "fc2")]
    opt = torch.optim.Adam(alphas, lr=cfg.lr_alpha)

    def qw(name):
        L = layers[name]
        return _soft_weight(L["kernel"], L["floor"], L["alpha"], L["delta"],
                            L["zp"], wspec)

    def act_q(x):
        if aspec is not None and lspec.act_quant and aspec.dynamic:
            return core.fake_quant_dynamic(x[None], aspec)[0]
        return x

    def linear(name, x):
        out = act_q(x) @ qw(name)
        return out if biases[name] is None else out + biases[name]

    losses = []
    with torch.enable_grad():
        for t in range(cfg.iters):
            idx = _draw(gen, n, bs, x2.device)
            out = linear("fc2", approx_gelu(linear("fc1", x2[idx])))
            loss = (torch.mean((out - y2[idx]) ** 2)
                    + round_loss(alphas, t, cfg))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    out = {name: {"w_alpha": L["alpha"].detach(), "w_delta": L["delta"],
                  "w_zp": L["zp"]} for name, L in layers.items()}
    out["recon_losses"] = torch.stack(losses) if losses else None
    return out


def capture_block_io(model: nn.Module, example_args, mode: str = "fp",
                     blocks: Optional[Sequence[int]] = None) -> Dict:
    """One forward with capture: {'blocks': {i: (input, output)}, 'y': the
    blocks' prompt context, 't0': their adaLN input} from each block's
    first call (JAX reconstruction.py:330-364); blocks: only these blocks'
    I/O (all by default). mode 'quant' rounds AdaRound's weights hard
    (alpha >= 0): the quantized input view of asym reconstruction."""
    want = range(len(model.blocks)) if blocks is None else blocks
    out: Dict = {"blocks": {}}

    def hook_of(i):
        def hook(mod, args, output):
            if i in out["blocks"]:
                return
            out["blocks"][i] = (args[0].detach(), output.detach())
            out.setdefault("y", args[1].detach())
            out.setdefault("t0", args[2].detach())
        return hook
    handles = [model.blocks[i].register_forward_hook(hook_of(i))
               for i in want]
    try:
        with torch.no_grad():
            model(*example_args, qctx=QuantCtx(mode=mode, capture=True,
                                               soft_targets=False))
    finally:
        for h in handles:
            h.remove()
    return out


def block_reconstruction(block: nn.Module, extra, x_fp: torch.Tensor,
                         y_fp: torch.Tensor, batch_args: Tuple,
                         cfg: ReconConfig = ReconConfig(),
                         qctx: QuantCtx = QuantCtx(mode="quant",
                                                   soft_targets=True),
                         gen: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
    """Optimise every AdaRound alpha of one block jointly (JAX
    reconstruction.py:280-327). block: the block computing in float32 with
    calibrated tables and initialised w_alpha (`standalone_block`), run as
    block(x, *batch_args, extra, qctx); x_fp [NB, N, C] its captured
    inputs, y_fp its fp outputs; batch_args: per-row inputs (y, t0, mask),
    minibatched where their leading dim is NB. The block's w_alpha buffers
    end optimised; returns them by layer name (and 'recon_losses')."""
    gen = gen if gen is not None else generator(0, 0)
    mods = sorted((name, m) for name, m in block.named_modules()
                  if isinstance(m, QuantLinear) and m.adaround)
    if not mods:
        return {}
    for _, m in mods:
        m.w_alpha = m.w_alpha.detach().float().clone().requires_grad_()
    alphas = [m.w_alpha for _, m in mods]
    n = x_fp.shape[0]
    bs = min(cfg.batch_size, n)
    x_fp = x_fp.float()
    y_fp = y_fp.float()
    opt = torch.optim.Adam(alphas, lr=cfg.lr_alpha)
    losses = []
    with torch.enable_grad():
        for t in range(cfg.iters):
            idx = _draw(gen, n, bs, x_fp.device)
            argsb = tuple(
                a[idx] if (isinstance(a, torch.Tensor) and a.dim() > 0
                           and a.shape[0] == n) else a
                for a in batch_args)
            out = block(x_fp[idx], *argsb, extra, qctx)
            loss = (torch.mean((out.float() - y_fp[idx]) ** 2)
                    + round_loss(alphas, t, cfg))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    res = {}
    for name, m in mods:
        m.w_alpha = m.w_alpha.detach()
        res[name] = m.w_alpha
    res["recon_losses"] = torch.stack(losses) if losses else None
    return res


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def model_block_reconstruction(model: nn.Module, example_args,
                               cfg: ReconConfig = ReconConfig(),
                               mask: Optional[torch.Tensor] = None,
                               asym: bool = True, seed: int = 0,
                               timings: Optional[Dict] = None
                               ) -> nn.Module:
    """Block reconstruction over every block, in place (JAX
    reconstruction.py:464-525; reference model_recon.py:13-52 at block
    granularity): the fp targets of every block from one forward, then,
    block by block, each block's AdaRound alphas against its fp output on
    its fp input, or with `asym` (the reference block_recon default, "use
    quant input to reconstruct fp output") on its quantized input
    re-captured through the already reconstructed blocks before it. The
    kv linear takes part (the JAX skip applies to layer reconstruction).
    example_args: the model's (x, t, y, mask); mask: the per-prompt mask,
    tiled to the batch. timings: a dict to fill with the seconds of each
    capture forward ('capture_s') and each block's optimisation
    ('block_s'), the device synchronised around each."""
    io = capture_block_io(model, example_args)
    if not io["blocks"]:
        raise ValueError("no block I/O captured")
    y_ctx, t0_ctx = io["y"], io["t0"]
    B = y_ctx.shape[0]
    if mask is not None and mask.shape[0] != B:
        mask = mask.repeat(B // mask.shape[0], 1)
    qctx = QuantCtx(mode="quant", soft_targets=True)
    for k, i in enumerate(sorted(io["blocks"])):
        target = model.blocks[i]
        if not any(isinstance(m, QuantLinear) and m.adaround
                   for m in target.modules()):
            continue
        x_in, y_out = io["blocks"][i]
        if asym:
            _sync(x_in)
            t0 = time.perf_counter()
            x_in = capture_block_io(model, example_args, mode="quant",
                                    blocks=(i,))["blocks"][i][0]
            _sync(x_in)
            if timings is not None:
                timings.setdefault("capture_s", []).append(
                    time.perf_counter() - t0)
        t0 = time.perf_counter()
        block, extra = model.standalone_block(i)
        res = block_reconstruction(block, extra, x_in, y_out,
                                   (y_ctx, t0_ctx, mask), cfg, qctx,
                                   generator(seed, k))
        mods = dict(target.named_modules())
        with torch.no_grad():
            for name, alpha in res.items():
                if name != "recon_losses":
                    mods[name].w_alpha.copy_(alpha)
        _sync(x_in)
        if timings is not None:
            timings.setdefault("block_s", []).append(time.perf_counter() - t0)
        del block, res
    return model
