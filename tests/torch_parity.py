"""Shared set-up of the PyTorch-port parity tests: a tiny STDiT, PixArt-Σ,
DiT (text and label conditions), Latte and MMDiT built in both packages on
the same weights.

The JAX model is initialised, its parameters are replaced by numpy draws
from a seed, and its tables are calibrated and packed by the JAX package;
the port's model of the same configuration loads those through
`viditq_tpu_torch.utils.bridge`. The size is chosen so the JAX package
really takes its kernel path: T*S = 256 tokens (the producer's N % 256),
S = 128 spatial tokens (the attention's n % 128), hidden*mlp_ratio = 256.
The tiny Σ takes a 96x96 latent: N = 48*48 = 2304 tokens, above the
one-shot kv range, so block 0's self-attention streams its kv in 9 blocks
of 256 (K6); block 1 compresses k/v with the 2x2 `sr` conv. DiT and
Latte take square latents (their spatial table is a square grid): DiT a
2x16x16 one and attends over all 128 tokens; Latte a 2x32x32 one, its
spatial blocks over S = 256 tokens (the JAX kernel), its temporal blocks
over T = 2 (the JAX package's XLA attention there, the port's K3). The tiny MMDiT
takes a 32x32 latent (256 image tokens, the producer's N % 256) and 8
caption tokens.
"""

import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from viditq_tpu.models.dit import DiT as JDiT
from viditq_tpu.models.dit import Latte as JLatte
from viditq_tpu.models.mmdit import MMDiT as JMMDiT
from viditq_tpu.models.pixart import PixArt as JPixArt
from viditq_tpu.models.stdit import STDiT as JSTDiT
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.quant import calibrate_weight_tables as j_calibrate
from viditq_tpu.quant.native_pack import pack_native_weights as j_pack
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch.models.dit import DiT, Latte
from viditq_tpu_torch.models.mmdit import MMDiT
from viditq_tpu_torch.models.pixart import PixArt
from viditq_tpu_torch.models.stdit import STDiT
from viditq_tpu_torch.utils.bridge import state_dict_from_flax
from viditq_tpu_torch.utils.config import load_quant_config

# One ATen thread a process. The parity tests run tiny tensors, and the
# suite runs as several pytest-xdist workers on a few cores: ATen's
# default of one OpenMP thread a core oversubscribes the CPU, and the
# workers' threads spin-wait against each other (on 6 workers and 8
# cores the suite's summed test time fell from 7752 s to 3915 s with
# this, 49 tests added). Every worker imports this module when it
# collects.
torch.set_num_threads(1)

SM8 = "configs/opensora/w8a8_tpu_fused_sm8.yaml"
SYM = "configs/opensora/w8a8_tpu_fused_sym.yaml"
# the reference semantics (asym per-channel weights, asym dynamic per-token
# acts) through the fused int8 dataflow (K1, K2, K3 emission, K4, K5)
FUSED = "configs/opensora/w8a8_tpu_fused.yaml"
# the reference ViDiT-Q W8A8 (asym per-channel weights, asym dynamic
# per-token acts); it runs on the native backend (`native_plan`)
DYN = "configs/opensora/w8a8_dynamic.yaml"
# ViDiT-Q's W4A8 recipe: asym per-channel 4-bit weights, asym dynamic
# per-token int8 acts, momentum channel balancing (CB) over two timeranges
# (`cb_plan` runs it on the fused kernels)
CB = "configs/opensora/w4a8_timestep_aware_cb.yaml"
# the CB statistic forwards: one timestep in each of CB's two timeranges
CB_STAT_T = (100, 900)
LATENT = (2, 16, 32)
TINY = dict(input_size=LATENT, hidden_size=64, depth=2, num_heads=4,
            caption_channels=32, model_max_length=8)
SIGMA_LATENT = (96, 96)
TINY_SIGMA = dict(input_size=96, hidden_size=64, depth=2, num_heads=4,
                  caption_channels=32, model_max_length=8,
                  kv_compress_sampling="conv", kv_compress_scale=2,
                  kv_compress_layers=(1,))
# DiT's spatial position table is a square grid (dit.py:108-110); Latte's
# spatial blocks need S = 256 tokens for the JAX kernel, DiT's full
# attention 2 x 64
DIT_LATENT = (2, 16, 16)
LATTE_LATENT = (2, 32, 32)
TINY_DIT = dict(input_size=DIT_LATENT, hidden_size=64, depth=2, num_heads=4,
                caption_channels=32, model_max_length=8)
# the label condition's classes: y holds labels in [0, N_CLASSES], the
# last the CFG's null label
N_CLASSES = 10
MMDIT_LATENT = (32, 32)
TINY_MMDIT = dict(input_size=32, hidden_size=64, depth=2, num_heads=4,
                  caption_channels=32, pooled_channels=32,
                  model_max_length=8)
# (JAX class, port class, configuration, latent) of each tiny model
KINDS = {"stdit": (JSTDiT, STDiT, TINY, LATENT),
         "sigma": (JPixArt, PixArt, TINY_SIGMA, SIGMA_LATENT),
         "dit": (JDiT, DiT, TINY_DIT, DIT_LATENT),
         "dit_label": (JDiT, DiT, {**TINY_DIT,
                                   "condition": f"label_{N_CLASSES}"},
                       DIT_LATENT),
         "latte": (JLatte, Latte, {**TINY_DIT, "input_size": LATTE_LATENT},
                   LATTE_LATENT),
         "mmdit": (JMMDiT, MMDiT, TINY_MMDIT, MMDIT_LATENT)}


@contextlib.contextmanager
def jax_kernel_path():
    """Drive the JAX package's kernel dispatch on the CPU (Pallas interpret
    mode), as tests/test_attention_model_dispatch.py does."""
    keys = ("VIDITQ_FORCE_FUSED", "VIDITQ_FORCE_ATTN_KERNEL")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def native_plan(impl=None):
    """Plan transform of both packages: the native backend, and the JAX
    impl to take ('pallas' runs K7a/K7b in interpret mode; the port runs
    every impl but 'fused' as the one K7a -> K7b dataflow)."""
    def transform(plan):
        plan = plan.with_backend("native")
        return dataclasses.replace(plan, default_layer=dataclasses.replace(
            plan.default_layer, impl=impl))
    return transform


def cb_plan(share: bool = True, sym: bool = False):
    """Plan transform of both packages: the CB recipe on the fused kernels
    (`.with_backend("fused")`), the q/k/v balancing scale pooled when
    share (`qkv_share_cs`), sym weights and acts when sym
    (benchmarks/bench_configs.py:153-182)."""
    def transform(plan):
        plan = plan.with_backend("fused")
        d = plan.default_layer
        d = dataclasses.replace(d, smooth_quant=dataclasses.replace(
            d.smooth_quant, qkv_share_cs=share))
        if sym:
            d = dataclasses.replace(
                d, weight=dataclasses.replace(d.weight, sym=True),
                act=dataclasses.replace(d.act, sym=True))
        return dataclasses.replace(plan, default_layer=d)
    return transform


def inputs(batch: int = 2, seed: int = 0, kind: str = "stdit"):
    """x [B, 4, *latent], t [B], y [B, 1, L, 32] (the label kind: int
    labels [B], the last batch row's the null label), mask [B, L] (one
    padded prompt) as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 4, *KINDS[kind][3])).astype(np.float32)
    t = np.full((batch,), 500, np.int32)
    y = rng.standard_normal((batch, 1, 8, 32)).astype(np.float32)
    if kind == "dit_label":
        y = rng.integers(0, N_CLASSES, batch).astype(np.int32)
        y[-1] = N_CLASSES
    mask = np.ones((batch, 8), np.int32)
    mask[-1, 5:] = 0
    return x, t, y, mask


def randomize(params, seed: int = 0, scale: float = 0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
        params)


def data_info(batch: int = 2):
    """PixArtMS's micro-condition inputs as numpy arrays: each row's image
    size [B, 2] and aspect ratio [B, 1]."""
    hw = np.array([[1024.0, 768.0], [512.0, 896.0]], np.float32)[:batch]
    return {"img_hw": hw, "aspect_ratio": hw[:, :1] / hw[:, 1:]}


def build_jax(plan_path=SM8, scan_blocks: bool = False, seed: int = 0,
              kind: str = "stdit", plan_fn=None, weight_scale: float = 0.1,
              sq_stat_t=(), act_scales=None, dtype=jnp.float32,
              **overrides):
    """(JAX model, variables as numpy trees) with calibrated, packed
    tables. plan_fn: a transform of the loaded plan (`native_plan`);
    weight_scale: the standard deviation of the parameter draws;
    sq_stat_t: the timesteps of the CB statistic forwards run first (the
    PTQ phase order: sq_stat, calibrate, pack), on the kernel path;
    act_scales: instead, a quant tree whose `act_scale` leaves to take
    (the statistic of a model on the same weights and inputs); dtype: the
    model's activation dtype. A micro-condition model is initialised
    with `data_info()`."""
    jcls, _, cfg, _ = KINDS[kind]
    plan = j_load(plan_path)
    resolver = (plan_fn(plan) if plan_fn else plan).resolver()
    if scan_blocks:  # STDiT's and PixArt's option
        overrides = {**overrides, "scan_blocks": True}
    model = jcls(resolver=resolver, dtype=dtype, **{**cfg, **overrides})
    x, t, y, mask = inputs(kind=kind)
    if "input_size" in overrides:
        x = x[..., :overrides["input_size"], :overrides["input_size"]]
    # jitted: only the variables' shapes and constant initial tables are
    # kept (the parameters are drawn below)
    extra = ({"data_info": data_info(x.shape[0])}
             if overrides.get("micro_condition") else {})
    v = dict(jax.jit(functools.partial(model.init, qctx=JQuantCtx(
        mode="fp")))(jax.random.PRNGKey(0), x, t, y, mask, **extra))
    params = randomize(v["params"], seed, weight_scale)
    quant = v["quant"]
    if sq_stat_t:
        quant = jax_sq_stat(model, {**v, "params": params},
                            (x, t, y, mask), sq_stat_t)
    elif act_scales is not None:
        quant = jax.tree_util.tree_map_with_path(
            lambda path, a: _leaf(act_scales, path)
            if path[-1].key == "act_scale" else a, quant)
    calibrate = (lambda p, q: j_pack(p, j_calibrate(p, q, resolver),
                                     resolver))
    if sq_stat_t or act_scales is not None:
        # CB tables: jitted, as the JAX package's W4A8 bench arm runs them
        # (benchmarks/bench_configs.py:208-219)
        calibrate = jax.jit(calibrate)
    quant = calibrate(params, quant)
    out = {"params": params, "quant": jax.tree.map(np.asarray, quant)}
    if "qstats" in v:  # CB: the statistic pass's state, read by apply
        out["qstats"] = jax.tree.map(np.asarray, v["qstats"])
    return model, out


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def jax_sq_stat(model, variables, args, t_ids):
    """The JAX package's 'sq_stat' forwards (one per timestep, the timestep
    input and t_id both t) on the kernel path; returns the quant tree with
    the accumulated act_scale."""
    x = args[0]

    @jax.jit
    def step(vs, t_id):
        tt = jnp.full((x.shape[0],), t_id, jnp.float32)
        _, muts = model.apply(vs, x, tt, *args[2:],
                              qctx=JQuantCtx(mode="sq_stat", t_id=t_id),
                              mutable=["quant", "qstats"])
        return {**vs, **muts}
    vs = dict(variables)
    with jax_kernel_path():
        for t_id in t_ids:
            vs = step(vs, jnp.asarray(t_id, jnp.int32))
    return vs["quant"]


def build_port(plan_path=SM8, variables=None, fp_only: bool = False,
               kind: str = "stdit", plan_fn=None, dtype=torch.float32,
               **overrides):
    """The port's model; loads the JAX variables through the bridge
    (params only with fp_only, to calibrate and pack in the port; with
    them the static act ranges of `qstats`, where the JAX model has
    any)."""
    _, pcls, cfg, _ = KINDS[kind]
    plan = load_quant_config(plan_path)
    model = pcls(resolver=(plan_fn(plan) if plan_fn else plan).resolver(),
                 dtype=dtype, **{**cfg, **overrides})
    if variables is not None:
        sd = state_dict_from_flax(
            variables["params"], None if fp_only else variables["quant"],
            None if fp_only else variables.get("qstats"))
        model.load_state_dict(sd, strict=not fp_only)
    return model.eval()


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def quant_ckpt_crosses(jv, port_fp, path, port_path):
    """A JAX-written quant checkpoint of jv's tables loads into the port's
    model of the same plan (port_fp, fp weights only) with every table
    equal to the bridged one, and the port's file of that model has the
    JAX file's keys but the packed slabs, with equal arrays."""
    from viditq_tpu.utils import ckpt as j_ckpt
    from viditq_tpu_torch.utils import ckpt
    from viditq_tpu_torch.utils.bridge import state_dict_from_flax
    j_ckpt.save_quant_ckpt(path, jv["quant"], {"act_slot_map": None})
    assert ckpt.load_quant_ckpt(path, port_fp)["act_slot_map"] is None
    bridged = state_dict_from_flax(jv["params"], jv["quant"])
    got = {k: v for k, v in port_fp.state_dict().items()
           if k.rpartition(".")[2] in ckpt.QUANT_TABLES}
    assert got
    for k, v in got.items():
        assert torch.equal(v, bridged[k]), k
    ckpt.save_quant_ckpt(port_path, port_fp, {"act_slot_map": None})
    keys, port = set(np.load(path).files), np.load(port_path)
    packed = {k for k in keys if k.split("::")[-1] in ckpt.PACKED}
    assert set(port.files) == keys - packed
    for k in set(port.files) - {"__meta__"}:
        assert np.array_equal(port[k], np.load(path)[k]), k
    return keys
