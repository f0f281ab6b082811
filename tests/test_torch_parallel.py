"""The port's mesh, Ulysses and ring attention, sequence-parallel STDiT,
the model stages and dp-sharded sampling (`viditq_tpu_torch/parallel/`)
against the JAX package, on a pool of 4 gloo CPU ranks (`torch_dist`)
started once for the file; the JAX side on the 8 virtual CPU devices.

Tolerances, each stated where it is held:
- Ulysses on the port's attention numerics (both packages' kernels round
  q and k to bf16 for q.k): 1e-6 from the port's single-process
  `attention_bnhd` (the same per-head sums), 1e-4 from JAX's Ulysses on
  its Pallas kernel (interpret mode, tests/test_parallel.py:124-143),
  1e-2 from f32 SDPA (the bf16 q.k).
- Ring attention is plain float32 in both packages: 2e-5 from f32 SDPA
  and from JAX's ring (tests/test_parallel.py:146).
- The tiny STDiT with sp (Ulysses, auto ring, forced ring) in float32:
  JAX's Pallas interpret mode does not compose with a jitted mesh
  program on the CPU, so JAX's sp model runs its XLA path, where it equals
  JAX's base model exactly (measured 0.0). The port's sp output is held
  1e-4 from JAX's base model on its kernel path (the fp parity limit),
  5e-4 from JAX's sp model (its XLA f32 attention against the kernels'
  bf16 q.k, ROADMAP C15: measured 1.5e-4), and 1e-5 from the port's
  single-process model (measured 0.0). Under ring the attention is float32
  (JAX's jnp) where the kernels round q and k to bf16, so the port's ring
  model is held 5e-4 from JAX's base model and its own single-process
  one (measured 1.5e-4 and 8.4e-5), as from JAX's sp model.
- The stages: embed -> blocks -> final equal to stage 'all' bit for bit.
- dp-sharded sampling (`quant_sample(mesh=)`, 2 DDIM steps at CFG 4):
  per-row dynamic quantization (the fused sm8 plan) does not see the
  batch split: 1e-5 from one process. The JAX test's simulate W8A8
  (tests/test_parallel_inference.py:30) pools each token's act scale over
  the batch rows of its view (token granularity, group shape (1, N, 1));
  JAX's GSPMD keeps that pool global (its sharded sampling measured
  4.3e-8 from its unsharded one), and so does the port (the dp ranks'
  maxima all-reduced): 1e-5 from the port's single process (measured
  0.0), and DP_SAMPLE_JAX from JAX's dp x sp sharded sampling on the same
  weights (measured 8.6e-3). The same plan under the 'dynamic'
  channel-balance type pools each layer's per-channel act maxima (a mean
  over batch rows) the same way, its row sums all-reduced: 1e-5 from one
  process (the mean's sums in another order), DP_SAMPLE_JAX from JAX's. That limit is the int8 noise floor of two
  steps (JAX's XLA f32 attention against the kernels' bf16 q.k, ROADMAP
  C15, flips rounding boundaries that the steps carry on): the port's
  single process sits as far from JAX's unsharded sampling (8.6e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist import RankPool, build, r_attention, r_mesh, r_stdit_sp
from torch_parity import (SM8, TINY, build_jax, inputs, jax_kernel_path,
                          randomize, rel_err)
from viditq_tpu.models.layers import sdpa as j_sdpa
from viditq_tpu.models.stdit import STDiT as JSTDiT
from viditq_tpu.parallel.mesh import make_mesh as j_make_mesh
from viditq_tpu.parallel.mesh import param_sharding_rules as j_rules
from viditq_tpu.parallel.ring import ring_attention as j_ring
from viditq_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu_torch.kernels.attention import attention_bnhd
from viditq_tpu_torch.parallel.mesh import (Mesh, param_sharding_rules,
                                            shard_params, tp_layout)
from viditq_tpu_torch.utils.bridge import state_dict_from_flax

ULYSSES_SELF = 1e-6
ULYSSES_JAX = 1e-4
ULYSSES_SDPA = 1e-2
RING_TOL = 2e-5
SP_JAX = 1e-4
SP_JAX_XLA = 5e-4
SP_SELF = 1e-5
DP_SAMPLE_SELF = 1e-5
DP_SAMPLE_JAX = 2e-2


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _sdpa_bnhd(q, k, v):
    """f32 softmax attention over [B, N, H, D] numpy arrays."""
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    s = np.exp(s - s.max(-1, keepdims=True))
    p = s / s.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("path", [
    "blocks_0/attn/q/kernel/", "blocks_0/attn/proj/kernel/",
    "blocks_0/mlp/fc1/kernel/", "blocks_0/mlp/fc2/kernel/",
    "t_embedder/fc1/kernel/", "blocks_0/attn/q/bias/",
    "blocks.3.cross_attn.kv_linear.kernel", "blocks.3.cross_attn.proj.bias",
    "blocks.3.attn_temp.v.kernel", "final_layer.linear.kernel",
    "blocks.0.scale_shift_table"])
def test_param_sharding_rules(path):
    """JAX's rules case by case (tests/test_parallel.py:35-41), on JAX's
    flax paths and the port's dotted names read with '/' for '.'."""
    path = path.replace(".", "/")
    assert param_sharding_rules(path) == tuple(j_rules(path))


def test_tp_cut_keeps_kv_heads_paired():
    """kv_linear [C, 2C]: each tp rank holds the same heads of k and of v;
    a column kernel's bias is cut with it; row kernels by rows."""
    C, n = 8, 2
    kv = torch.arange(C * 2 * C, dtype=torch.float32).reshape(C, 2 * C)
    sd = {"blocks.0.cross_attn.kv_linear.kernel": kv,
          "blocks.0.cross_attn.kv_linear.bias": torch.arange(
              2 * C, dtype=torch.float32),
          "blocks.0.attn.proj.kernel": kv[:, :C],
          "blocks.0.attn.proj.bias": torch.ones(C)}
    for r in range(n):
        mesh = Mesh({"dp": 1, "sp": 1, "tp": n, "pp": 1},
                    {"dp": 0, "sp": 0, "tp": r, "pp": 0},
                    {a: None for a in "dp sp tp pp".split()},
                    {a: (0,) for a in "dp sp tp pp".split()})
        cut = shard_params(sd, mesh)
        h = C // n
        k_cols = list(range(r * h, (r + 1) * h))
        v_cols = [C + c for c in k_cols]
        assert torch.equal(cut["blocks.0.cross_attn.kv_linear.kernel"],
                           kv[:, k_cols + v_cols])
        assert torch.equal(cut["blocks.0.cross_attn.kv_linear.bias"],
                           sd["blocks.0.cross_attn.kv_linear.bias"][
                               k_cols + v_cols])
        assert torch.equal(cut["blocks.0.attn.proj.kernel"],
                           kv[r * h:(r + 1) * h, :C])
        assert torch.equal(cut["blocks.0.attn.proj.bias"], torch.ones(C))
    assert tp_layout("t_embedder.fc1.kernel") is None


def test_make_mesh_lays_ranks_out_as_jax(pool):
    """(dp, sp, tp, pp) = (2, 1, 2, 1) over 4 ranks: each rank's
    coordinates and axis groups as JAX reshapes its devices (mesh.py:
    28-29); a 2-rank mesh leaves ranks 2 and 3 out."""
    jm = j_make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    got = pool.run(r_mesh, {"dp": 2, "tp": 2})
    for rank, (shape, coord, ranks) in enumerate(got):
        assert shape == {"dp": 2, "sp": 1, "tp": 2, "pp": 1}
        idx = tuple(coord[a] for a in ("dp", "sp", "tp", "pp"))
        assert ids[idx] == rank
        assert ranks["tp"] == tuple(int(i) for i in ids[idx[0], 0, :, 0])
        assert ranks["dp"] == tuple(int(i) for i in ids[:, 0, idx[2], 0])
    got = pool.run(r_mesh, {"sp": 2}, [0, 1])
    assert got[2] is None and got[3] is None
    assert [g[1]["sp"] for g in got[:2]] == [0, 1]


def test_ulysses_attention_matches_single_sdpa_and_jax(pool):
    """At JAX's kernel composition shape (test_parallel.py:124-143): sp=2,
    8 heads of 64 over N = 256."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 256, 8, 64)).astype(np.float32)
               for _ in range(3))
    got = pool.run(r_attention, "ulysses", q, k, v, 2, [0, 1])
    assert got[2] is None
    np.testing.assert_array_equal(got[0], got[1])
    single = attention_bnhd(*(torch.from_numpy(a) for a in (q, k, v)),
                            scale=64 ** -0.5).numpy()
    assert rel_err(got[0], single) <= ULYSSES_SELF
    mesh = j_make_mesh(dp=1, sp=2, tp=1, devices=jax.devices()[:2])
    with jax_kernel_path():
        want = np.asarray(j_ulysses(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), mesh))
    assert rel_err(got[0], want) <= ULYSSES_JAX
    assert rel_err(got[0], _sdpa_bnhd(q, k, v)) <= ULYSSES_SDPA


def test_ulysses_refuses_heads_not_dividing(pool):
    q = np.zeros((1, 8, 3, 16), np.float32)
    with pytest.raises(RuntimeError, match="heads 3 not divisible by sp=2"):
        pool.run(r_attention, "ulysses", q, q, q, 2, [0, 1])


def test_ring_attention_matches_sdpa_and_jax(pool):
    """sp = 4 over 2 heads (more ranks than heads: Ulysses cannot run it,
    tests/test_parallel.py:146-161)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
               for _ in range(3))
    got = pool.run(r_attention, "ring", q, k, v, 4)
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    assert rel_err(got[0], _sdpa_bnhd(q, k, v)) <= RING_TOL
    mesh = j_make_mesh(dp=1, sp=4, tp=1, devices=jax.devices()[:4])
    want = np.asarray(j_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             mesh))
    assert rel_err(got[0], want) <= RING_TOL
    jsd = j_sdpa(*(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
                 16 ** -0.5).transpose(0, 2, 1, 3)
    assert rel_err(want, np.asarray(jsd)) <= RING_TOL


def _jax_fp(cfg, sp, sp_mode):
    """JAX's tiny fp STDiT on the weights of torch_parity (numpy x 0.1):
    its sp model's output (XLA path: the Pallas kernels' interpret mode
    does not compose with a jitted mesh program on the CPU), its base
    model's on the kernel path, the state dict bridged."""
    x, t, y, mask = inputs()
    tt = t.astype(np.float32)
    base = JSTDiT(dtype=jnp.float32, **cfg)
    v = jax.jit(base.init)(jax.random.PRNGKey(0), x, tt, y, mask)
    params = randomize(v["params"], 0, 0.1)
    mesh = j_make_mesh(dp=1, sp=sp, tp=1, devices=jax.devices()[:sp])
    spm = JSTDiT(dtype=jnp.float32, sp_mesh=mesh, sp_mode=sp_mode, **cfg)
    out = np.asarray(jax.jit(spm.apply)({"params": params}, x, tt, y, mask))
    with jax_kernel_path():
        ref = np.asarray(jax.jit(base.apply)({"params": params}, x, tt, y,
                                             mask))
    sd = {k: v.numpy() for k, v in state_dict_from_flax(params).items()}
    return out, ref, sd, (x, t, y, mask)


@pytest.mark.parametrize("heads,sp,sp_mode", [
    (4, 2, "auto"),       # Ulysses (tests/test_parallel.py:54)
    (2, 4, "auto"),       # heads % sp != 0: ring (:163)
    (4, 2, "ring")])      # forced ring (:187)
def test_stdit_sp_matches_jax_and_single(pool, heads, sp, sp_mode):
    cfg = {**TINY, "num_heads": heads}
    want_sp, want_kernel, sd, args = _jax_fp(cfg, sp, sp_mode)
    got = pool.run(r_stdit_sp, cfg, sd, args, sp, sp_mode, None,
                   list(range(sp)))
    for g in got[1:sp]:
        np.testing.assert_array_equal(g, got[0])
    single = build("stdit", cfg, sd)
    x, t, y, mask = (torch.from_numpy(a) for a in args)
    with torch.no_grad():
        ref = single(x, t.float(), y, mask).numpy()
    ring = sp_mode == "ring" or heads % sp
    assert rel_err(got[0], want_sp) <= SP_JAX_XLA
    assert rel_err(got[0], want_kernel) <= (SP_JAX_XLA if ring else SP_JAX)
    assert rel_err(got[0], ref) <= (SP_JAX_XLA if ring else SP_SELF)


def test_stdit_sp_sm8_matches_jax(pool):
    """Ulysses under the sm8 plan: the K1 producers stand aside, q/k/v
    share one K4 pass, the attention is bf16-PV K3 and the projs take the
    float output (no emission, no softmax or PV quantizers: ROADMAP C22),
    in both packages; JAX's sp model on its XLA path (see `_jax_fp`).
    Held to the sm8 parity limit 1e-2 (measured 6.4e-3: the int8 noise
    floor, which JAX's own XLA and kernel paths also show between them)."""
    jm, jv = build_jax(SM8)
    mesh = j_make_mesh(dp=1, sp=2, tp=1, devices=jax.devices()[:2])
    x, t, y, mask = inputs()
    want = np.asarray(jax.jit(functools.partial(
        jm.clone(sp_mesh=mesh).apply,
        qctx=JQuantCtx(mode="quant", t_id=jnp.asarray(500))))(
            jv, x, t.astype(np.float32), y, mask))
    sd = {k: v.numpy() for k, v in state_dict_from_flax(
        jv["params"], jv["quant"]).items()}
    got = pool.run(r_stdit_sp, TINY, sd, (x, t, y, mask), 2, "auto", SM8,
                   [0, 1])
    np.testing.assert_array_equal(got[0], got[1])
    assert rel_err(got[0], want) <= 1e-2


@pytest.mark.parametrize("kind,quant", [("stdit", False), ("stdit", True),
                                        ("pixart", False)])
def test_stages_compose_to_all(kind, quant):
    """embed -> every block -> final equals the forward at stage 'all',
    bit for bit (stdit.py:212-233, pixart.py:139-164)."""
    from viditq_tpu_torch.models.layers import call_block
    from torch_dist import qctx_of
    cfg = (TINY if kind == "stdit" else
           dict(input_size=32, hidden_size=64, depth=2, num_heads=4,
                caption_channels=32, model_max_length=8))
    torch.manual_seed(0)
    model = build(kind, cfg, None, SM8 if quant else None)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    if quant:
        from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
        from viditq_tpu_torch.quant.native_pack import pack_native_weights
        pack_native_weights(calibrate_weight_tables(model))
    x, t, y, mask = inputs()
    if kind == "pixart":
        x = np.random.default_rng(0).standard_normal(
            (2, 4, 32, 32)).astype(np.float32)
    x, t, y, mask = (torch.from_numpy(a) for a in (x, t, y, mask))
    qctx = qctx_of(quant)
    with torch.no_grad():
        want = model(x, t.float(), y, mask, qctx)
        h, t0, y2, m2, aux = model(x, t.float(), y, mask, qctx,
                                   stage="embed")
        for i, blk in enumerate(model.blocks):
            extra = aux if kind == "pixart" else (aux if i == 0 else None)
            h = call_block(blk, False, h, y2, t0, m2, extra, qctx)
        got = model(x, t.float(), y, mask, qctx, stage="final", x_tokens=h)
    assert torch.equal(got, want)


def _jax_dp_sample(jm, jv, z, y_c, mask, steps, dp):
    """JAX's 2-step CFG DDIM with z, y and mask sharded over dp on a dp x
    sp=2 mesh (tests/test_parallel_inference.py:30-75), or unsharded
    (dp None)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from viditq_tpu.samplers import IDDPM as JIDDPM
    from viditq_tpu.samplers.iddpm import default_qctx_factory
    sampler = JIDDPM(num_sampling_steps=steps, cfg_scale=4.0)
    y = jnp.concatenate([y_c, y_c * 0], axis=0)

    def run(z, y, m):
        return sampler.sample(
            lambda x, t, yy, mm, q: jm.apply(jv, x, t, yy, mm, q), z, y, m,
            sampler_type="ddim", qctx_factory=default_qctx_factory("quant"))
    if dp is None:
        return np.asarray(jax.jit(run)(z, y, mask))
    mesh = j_make_mesh(dp=dp, sp=2, tp=1, devices=jax.devices()[:2 * dp])
    sh, rep = NamedSharding(mesh, P("dp")), NamedSharding(mesh, P())
    return np.asarray(jax.jit(run, in_shardings=(sh, sh, sh),
                              out_shardings=rep)(
        *(jax.device_put(a, sh) for a in (z, y, mask))))


def _jax_w8a8(cfg, z, y_c, mask, dynamic_cb=False):
    """JAX's W8A8 STDiT of tests/test_parallel_inference.py:21-30 on numpy
    weights x 0.1, its weight tables calibrated: (model, variables, the
    port's state); dynamic_cb: every layer channel-balanced by the
    'dynamic' type (torch_dist.token_w8a8_resolver's)."""
    from torch_dist import DYNCB_ALPHA
    from viditq_tpu.quant import LayerQuantSpec as JLQS
    from viditq_tpu.quant import QuantSpec as JQS
    from viditq_tpu.quant import calibrate_weight_tables as j_calibrate
    from viditq_tpu.quant import resolve_layer_spec as j_resolve
    from viditq_tpu.quant.spec import SmoothQuantSpec as JSQS
    spec = JLQS(weight=JQS(n_bits=8, granularity="channel", channel_axis=-1,
                           round_mode="nearest"),
                act=JQS(n_bits=8, granularity="token",
                        round_mode="nearest_ste", dynamic=True),
                smooth_quant=JSQS(enable=dynamic_cb,
                                  channel_wise_scale_type="dynamic",
                                  alpha=DYNCB_ALPHA))
    fp = ("x_embedder", "t_block", "t_embedder", "y_embedder",
          "final_layer")
    jm = JSTDiT(dtype=jnp.float32, resolver=lambda n: j_resolve(n, spec, fp),
                **cfg)
    v = dict(jax.jit(functools.partial(jm.init, qctx=JQuantCtx(mode="fp")))(
        jax.random.PRNGKey(0), z, np.zeros(len(z), np.float32), y_c, mask))
    v["params"] = randomize(v["params"], 0, 0.1)
    v["quant"] = j_calibrate(v["params"], v["quant"], jm.resolver)
    sd = {k: t.numpy() for k, t in state_dict_from_flax(
        v["params"], v["quant"]).items()}
    return jm, v, sd


@pytest.mark.parametrize("plan", [SM8, "token_w8a8", "token_w8a8_dyncb"])
def test_dp_sharded_quant_sampling(pool, plan):
    """`quant_sample` with the batch sharded over dp on a dp=2 x sp=2 mesh
    (tests/test_parallel_inference.py:30, the sp ranks replicas) against
    one process on the whole batch, and under JAX's W8A8 against JAX's
    GSPMD-sharded sampling on the same weights: the token scales pooled
    over the global batch in both, and under the 'dynamic' channel-balance
    type (token_w8a8_dyncb) its per-channel act maxima too."""
    from torch_dist import dp_sample, r_dp_sample
    cfg = dict(input_size=(4, 8, 8), hidden_size=64, depth=2, num_heads=4,
               caption_channels=32, model_max_length=8)
    if plan == SM8:
        cfg["input_size"] = (2, 16, 32)
    rng = np.random.default_rng(0)
    B = 4
    z = rng.standard_normal((B, 4, *cfg["input_size"])).astype(np.float32)
    y_c = rng.standard_normal((B, 1, 8, 32)).astype(np.float32)
    mask = np.ones((B, 8), np.int32)
    mask[-1, 5:] = 0
    if plan == SM8:
        model = build("stdit", cfg)
        sd = {n: (rng.standard_normal(p.shape) * 0.1).astype(np.float32)
              for n, p in model.named_parameters()}
    else:
        jm, jv, sd = _jax_w8a8(cfg, z, y_c, mask,
                               dynamic_cb=plan == "token_w8a8_dyncb")
    got = pool.run(r_dp_sample, cfg, sd, plan, z, y_c, mask, 2,
                   {"dp": 2, "sp": 2})
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    assert got[0].shape == z.shape and np.isfinite(got[0]).all()
    single = dp_sample(cfg, sd, plan, z, y_c, mask, 2)
    assert rel_err(got[0], single) <= DP_SAMPLE_SELF
    if plan != SM8:
        want = _jax_dp_sample(jm, jv, z, y_c, mask, 2, 2)
        assert rel_err(got[0], want) <= DP_SAMPLE_JAX
