"""The port's checkpoint files (`viditq_tpu_torch/utils/ckpt.py`) against
the JAX package's (`viditq_tpu/utils/ckpt.py`).

A reference-layout `.pth` is made from a JAX tiny model's parameter tree
(numpy draws from a seed): the tree goes through the bridge to the port's
state dict and `reference_state_dict` inverts the port's names and
layouts (fused self-attention `qkv`, Linear weights [out, in], the
patchify conv [D, C_in, *k], the `y_embedding`, the recomputed
`pos_embed` tables beside them). Saved raw, under 'state_dict' and under
'ema', it must convert in the port to exactly the bridged state dict and
in the JAX package to exactly the tree it was made from: the JAX
converter is the check on the inverse. Quant checkpoints: the port's
round trip, a JAX-written file of the W4A8 channel-balancing (CB) plan on
the fused kernels (its `cbshare__*` copies held and dropped, its tables
equal to the bridged ones, the port's file of the same model with JAX's
key set but the packed slabs), and the meta unpickler's refusal of a
class outside numpy and builtins.
"""

import fractions
import functools
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from torch_parity import (CB, KINDS, build_port, cb_plan, inputs, randomize)
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.quant import calibrate_weight_tables as j_calibrate
from viditq_tpu.utils import ckpt as j_ckpt
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch import cli
from viditq_tpu_torch.pipelines import inference as p_inf
from viditq_tpu_torch.pipelines.ptq import run_ptq
from viditq_tpu_torch.quant.qlinear import QuantLinear
from viditq_tpu_torch.samplers.iddpm import IDDPM
from viditq_tpu_torch.utils import ckpt, workload
from viditq_tpu_torch.utils.bridge import state_dict_from_flax
from viditq_tpu_torch.utils.config import load_quant_config

NAIVE = "configs/opensora/w8a8_naive.yaml"


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _jax_init(kind, plan_path=NAIVE, plan_fn=None):
    jcls, _, cfg, _ = KINDS[kind]
    plan = j_load(plan_path)
    model = jcls(resolver=(plan_fn(plan) if plan_fn else plan).resolver(),
                 dtype=jax.numpy.float32, **cfg)
    x, t, y, mask = inputs(kind=kind)
    v = jax.jit(functools.partial(model.init, qctx=JQuantCtx(mode="fp")))(
        jax.random.PRNGKey(0), x, t, y, mask)
    return model, dict(v)


@pytest.fixture(scope="module", params=["stdit", "sigma"])
def reference(request, tmp_path_factory):
    """(kind, JAX params, the port's state dict, reference .pth paths by
    wrapping)."""
    kind = request.param
    _, v = _jax_init(kind)
    params = randomize(v["params"], seed=3)
    port_sd = state_dict_from_flax(params)
    patch = ckpt.patch_of(build_port(kind=kind))
    ref = ckpt.reference_state_dict(port_sd, patch)
    g = torch.Generator().manual_seed(0)
    ref["pos_embed"] = torch.randn(1, 16, 64, generator=g)
    if kind == "stdit":
        ref["pos_embed_temporal"] = torch.randn(1, 2, 64, generator=g)
    d = tmp_path_factory.mktemp(f"ref_{kind}")
    paths = {}
    for wrap, obj in (("raw", ref), ("state_dict", {"state_dict": ref}),
                      ("ema", {"ema": ref, "step": 7})):
        paths[wrap] = str(d / f"{wrap}.pth")
        torch.save(obj, paths[wrap])
    return kind, params, port_sd, paths


def test_reference_layout_is_the_references(reference):
    kind, _, port_sd, paths = reference
    ref = torch.load(paths["raw"], weights_only=True)
    # fused self-attention qkv, Linear [out, in], the patch conv [D, C, *k]
    for attn in ("blocks.0.attn",) + (("blocks.0.attn_temp",)
                                      if kind == "stdit" else ()):
        assert ref[f"{attn}.qkv.weight"].shape == (192, 64)
        assert ref[f"{attn}.qkv.bias"].shape == (192,)
        assert f"{attn}.q.weight" not in ref
    assert ref["blocks.0.cross_attn.kv_linear.weight"].shape == (128, 64)
    assert ref["t_embedder.mlp.0.weight"].shape == (64, 256)
    assert ref["y_embedder.y_proj.fc1.weight"].shape == (64, 32)
    patch = (1, 2, 2) if kind == "stdit" else (2, 2)
    assert ref["x_embedder.proj.weight"].shape == (64, 4) + patch
    assert torch.equal(ref["y_embedder.y_embedding"],
                       port_sd["y_embedder.y_embedding"])
    if kind == "sigma":
        assert ref["blocks.1.attn.sr.weight"].shape == (64, 1, 2, 2)
        assert "blocks.1.attn.norm.weight" in ref


@pytest.mark.parametrize("wrap", ["raw", "state_dict", "ema"])
def test_port_converter_gives_the_bridged_state_dict(reference, wrap):
    kind, _, port_sd, paths = reference
    got = ckpt.convert_dit_checkpoint(paths[wrap])
    assert got.keys() == port_sd.keys()
    for k, v in port_sd.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("wrap", ["raw", "ema"])
def test_jax_converter_gives_back_the_tree(reference, wrap):
    kind, params, _, paths = reference
    convert = (j_ckpt.convert_stdit_checkpoint if kind == "stdit"
               else j_ckpt.convert_pixart_checkpoint)
    got, want = _flat(convert(paths[wrap])), _flat(params)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


def test_split_ckpt_command_round_trip(reference, tmp_path):
    kind, _, port_sd, paths = reference
    dst = str(tmp_path / "params.pt")
    cli.main(["split-ckpt", "--src", paths["state_dict"], "--dst", dst,
              "--model_type", "opensora" if kind == "stdit" else "pixart"])
    got = ckpt.load_params(dst)
    assert got.keys() == port_sd.keys()
    assert all(torch.equal(got[k], v) for k, v in port_sd.items())
    # and the model takes it, every parameter
    model = ckpt.load_params_into(build_port(kind=kind), dst)
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), port_sd[k]), k


def _calibrated_naive(seed=0):
    """The tiny STDiT under w8a8_naive (static acts), calibrated by run_ptq
    on a 2-step fp trajectory."""
    x, _, y, mask = (torch.from_numpy(a) for a in inputs(seed=seed))
    model = workload.random_init_(build_port(NAIVE), seed, 0.1)
    sampler = IDDPM(num_sampling_steps=2)
    cal = p_inf.get_calib_data(model, sampler, x[:1], y, mask[:1])
    res = run_ptq(model, cal, load_quant_config(NAIVE))
    return model, res


def _tables(model):
    return {f"{n}.{t}": getattr(m, t).clone()
            for n, m in model.named_modules() if isinstance(m, QuantLinear)
            for t in ckpt.QUANT_TABLES if hasattr(m, t)}


def test_port_quant_ckpt_round_trip(tmp_path):
    model, res = _calibrated_naive()
    path = str(tmp_path / "q.npz")
    meta = {"act_slot_map": res.act_slot_map, "calib_ts": res.calib_ts,
            "ptq_config": NAIVE}
    ckpt.save_quant_ckpt(path, model, meta)
    fresh = build_port(NAIVE)
    got_meta = ckpt.load_quant_ckpt(path, fresh)
    assert np.array_equal(got_meta["act_slot_map"], res.act_slot_map)
    assert np.array_equal(got_meta["calib_ts"], res.calib_ts)
    assert got_meta["ptq_config"] == NAIVE
    want, got = _tables(model), _tables(fresh)
    assert want.keys() == got.keys() and any("a_delta" in k for k in want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # a layer the model lacks, a table of another shape
    data = dict(np.load(path))
    for bad, err in ((dict(data, **{"nowhere.q::w_delta": np.ones(1)}),
                      KeyError),
                     (dict(data, **{"blocks.0.attn.q::w_delta":
                                    np.ones((1, 1, 1, 3), np.float32)}),
                      ValueError)):
        np.savez(str(tmp_path / "bad.npz"), **bad)
        with pytest.raises(err):
            ckpt.load_quant_ckpt(str(tmp_path / "bad.npz"), build_port(NAIVE))


@pytest.fixture(scope="module")
def jax_cb_ckpt(tmp_path_factory):
    """A JAX-written quant checkpoint of the tiny STDiT under the CB plan
    on the fused kernels (q/k/v scale pooled): random act statistics,
    then the JAX package's calibration (cb_scale, its cbshare copies, the
    per-timerange weight tables)."""
    model, v = _jax_init("stdit", CB, cb_plan())
    params = randomize(v["params"], seed=5)
    rng = np.random.default_rng(6)
    quant = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.abs(rng.standard_normal(a.shape)) + 0.1).astype(
            np.float32) if p[-1].key == "act_scale" else a, v["quant"])
    resolver = cb_plan()(j_load(CB)).resolver()
    quant = jax.tree.map(np.asarray, jax.jit(functools.partial(
        j_calibrate, resolve=resolver))(params, quant))
    path = str(tmp_path_factory.mktemp("jcb") / "quant_ckpt.npz")
    j_ckpt.save_quant_ckpt(path, quant, {"act_slot_map": None,
                                         "calib_ts": np.arange(3),
                                         "ptq_config": CB})
    return params, quant, path


def test_jax_cb_quant_ckpt_in_the_port(jax_cb_ckpt, tmp_path):
    params, quant, path = jax_cb_ckpt
    keys = set(np.load(path).files)
    assert any("::cbshare__" in k for k in keys)
    model = build_port(CB, {"params": params}, fp_only=True,
                       plan_fn=cb_plan())
    meta = ckpt.load_quant_ckpt(path, model)
    assert meta["act_slot_map"] is None and meta["ptq_config"] == CB
    bridged = state_dict_from_flax(params, quant)
    got = _tables(model)
    assert got and all("cbshare" not in k for k in bridged)
    for k, v in got.items():
        assert torch.equal(v, bridged[k]), k
    # the port's file of the same model: JAX's key set, but the slabs
    ckpt.save_quant_ckpt(str(tmp_path / "port.npz"), model,
                         {"act_slot_map": None})
    port_keys = set(np.load(str(tmp_path / "port.npz")).files)
    packed = {k for k in keys if k.split("::")[-1] in ckpt.PACKED}
    assert packed and port_keys == keys - packed
    port = np.load(str(tmp_path / "port.npz"))
    for k in port_keys - {"__meta__"}:
        assert np.array_equal(port[k], np.load(path)[k]), k


def test_cbshare_copy_that_differs_is_refused(jax_cb_ckpt, tmp_path):
    _, _, path = jax_cb_ckpt
    data = dict(np.load(path))
    key = next(k for k in data if "::cbshare__" in k)
    data[key] = data[key] * 2
    np.savez(str(tmp_path / "bad.npz"), **data)
    with pytest.raises(ValueError, match="not a copy"):
        ckpt.read_quant_ckpt(str(tmp_path / "bad.npz"))


def test_meta_unpickler_refuses_other_classes(tmp_path):
    ok = {"act_slot_map": np.arange(4, dtype=np.int32),
          "calib_ts": np.array([1, 2]), "ptq_config": "x.yaml"}
    raw = np.frombuffer(pickle.dumps(ok), np.uint8)
    got = ckpt.load_meta(raw)
    assert np.array_equal(got["act_slot_map"], ok["act_slot_map"])
    for bad in ({"k": fractions.Fraction(1, 2)}, {"k": os.getcwd}):
        raw = np.frombuffer(pickle.dumps(bad), np.uint8)
        with pytest.raises(pickle.UnpicklingError, match="not numpy"):
            ckpt.load_meta(raw)
        np.savez(str(tmp_path / "m.npz"), __meta__=raw)
        with pytest.raises(pickle.UnpicklingError):
            ckpt.read_quant_ckpt(str(tmp_path / "m.npz"))
