"""The port's sharding rules, hints and mesh helpers in one process.

  * Rules parity: for all ten archs at their FULL configs (``meta`` tensors,
    nothing allocated), every parameter leaf's spec and the divisibility
    fallbacks equal the reference's (``repro.sharding.rules`` on
    ``jax.sharding.AbstractMesh``) for ``param_rules(fsdp=True)`` and
    ``opt_state_rules`` on (1, 1), (2, 2, 2), (16, 16) and (2, 16, 16);
    ``cache_rules`` (both ``seq_shard``) and ``delivery_rules`` on (2, 2).
    The port keeps one leaf per layer where the reference stacks a group's
    layers under a leading "layers" axis (mapped to None by every rule), so
    a stacked reference spec is compared without that entry.
  * One-rank cases on a world-size-1 gloo group (a fixture starts it and
    destroys it): the kernel wrappers refuse a DTensor, the mesh functions
    check the world, and the train step, the delivery engine, the MoE
    dispatcher and ``compressed_psum`` on a (1, 1) mesh agree with their
    unsharded selves.

The multi-rank cases are ``tests/test_torch_distributed.py``'s.
"""
import collections
import contextlib
import dataclasses
import datetime
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS, get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.base import param_axes as jparam_axes  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.base import abstract_params, param_axes  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.sharding.hints import (  # noqa: E402
    ambient_mesh, hint, hint_spec)

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
CACHE_BATCH, CACHE_LEN = 8, 256


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), R.MeshShape(names, sizes)


def _leaves(tree, path=()):
    """(path, leaf) of nested dicts / lists; tuples of names are leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ref_path(cfg, path):
    """The reference leaf a port leaf maps to, and whether it is stacked
    (a leading "layers" axis the port's per-layer leaf does not have)."""
    if path[0] == "dec":
        sub, stacked = _ref_path(cfg, path[1:])
        return ("dec",) + sub, stacked
    if path[0] == "enc_blocks":
        return ("enc_blocks", "b0") + path[2:], True
    if path[0] != "blocks":
        return path, False
    i, n_pre, P = path[1], len(cfg.prefix_pattern), len(cfg.block_pattern)
    if i < n_pre:
        return ("prefix", i) + path[2:], False
    j = i - n_pre
    if j < cfg.n_groups * P:
        return ("blocks", f"b{j % P}") + path[2:], True
    return ("suffix", j - cfg.n_groups * P) + path[2:], False


def _hold(port_rules, ref_rules, cfg, axes, shapes, jaxes, jshapes,
          check_leaf=None):
    """Every port leaf's spec and fallbacks against its reference leaf's;
    every reference leaf reached.  Returns the port's fallbacks."""
    port_fb, reached = [], set()
    for path, ax in _leaves(axes):
        shape = tuple(_get(shapes, path).shape)
        rpath, stacked = _ref_path(cfg, path)
        reached.add(rpath)
        rax, rshape = _get(jaxes, rpath), tuple(_get(jshapes, rpath).shape)
        fb, rfb = [], []
        spec = port_rules.spec_for(ax, shape, fb)
        rspec = tuple(ref_rules.spec_for(rax, rshape, rfb))
        if stacked:
            assert rax[0] == "layers" and rspec[0] is None, (rpath, rspec)
            rspec = rspec[1:]
        if check_leaf is not None and check_leaf(path, spec, rspec):
            pass
        else:
            assert spec == rspec, (path, spec, rspec)
        assert fb == rfb, (path, fb, rfb)
        port_fb += fb
    jpaths = {p for p, _ in _leaves(jaxes)}
    assert reached == jpaths, sorted(map(str, jpaths ^ reached))
    return port_fb


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_rules_match_the_reference(arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    cfg = get_config(arch)
    model, jmodel = Model(cfg, device="cpu"), JModel(jget_config(arch))
    axes, shapes = model.axes(), model.abstract_params()
    jaxes, jshapes = jmodel.axes(), jmodel.abstract_params()
    for port_rules, ref_rules in (
            (R.param_rules(pmesh, fsdp=True),
             JR.param_rules(jmesh, fsdp=True)),
            (R.opt_state_rules(pmesh), JR.opt_state_rules(jmesh))):
        fb = _hold(port_rules, ref_rules, cfg, axes, shapes, jaxes, jshapes)
        jfb = []
        JR.tree_shardings(ref_rules, jaxes, jshapes, jfb)
        tree_fb = []
        R.tree_shardings(port_rules, axes, shapes, tree_fb)
        assert tree_fb == fb
        assert set(fb) == set(jfb), (set(fb) ^ set(jfb))
    assert all(t.device.type == "meta" for _, t in _leaves(shapes))


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_rules_match_the_reference(arch, seq_shard):
    """The port's attention caches keep ``pos`` per batch row, (B, slots),
    where the reference keeps one (slots,) vector: that leaf's spec is the
    reference's after its batch entry, which is the batch dim's."""
    jmesh, pmesh = AbstractMesh((2, 2), ("data", "model")), R.MeshShape(
        ("data", "model"), (2, 2))
    cfg = get_config(arch)
    model, jmodel = Model(cfg, device="cpu"), JModel(jget_config(arch))
    schema = model.cache_schema(CACHE_BATCH, CACHE_LEN)
    axes, shapes = param_axes(schema), abstract_params(schema, cfg.adtype)
    jschema = jmodel.cache_schema(CACHE_BATCH, CACHE_LEN)
    jaxes, jshapes = jparam_axes(jschema), jmodel.abstract_cache(CACHE_BATCH,
                                                                 CACHE_LEN)
    rules = R.cache_rules(pmesh, seq_shard=seq_shard)
    batch = rules.spec_for(("batch",), (CACHE_BATCH,))[0]

    def pos(path, spec, rspec):
        if path[-1] != "pos":
            return False
        assert spec == (batch,) + rspec, (path, spec, rspec)
        return True

    _hold(rules, JR.cache_rules(jmesh, seq_shard=seq_shard), cfg, axes,
          shapes, jaxes, jshapes, check_leaf=pos)


DELIVERY_ARRAYS = {     # the engine's microbatch and stacked secrets
    "x": ("group", "rows", "features"),
    "gidx": ("group",),
    "tokens": ("group", "rows", None),
    "cores": ("tenant", "core_in", "core_out"),
    "augs": ("tenant", "features", "out_features"),
}


@pytest.mark.parametrize("groups", [1, 2, 3, 4, 8])
def test_delivery_rules_match_the_reference(groups):
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    pmesh = R.MeshShape(("data", "model"), (2, 2))
    shapes = {"x": (groups, 64, 72), "gidx": (groups,),
              "tokens": (groups, 4, 16), "cores": (8, 36, 36),
              "augs": (8, 72, 64)}
    for name, ax in DELIVERY_ARRAYS.items():
        fb, jfb = [], []
        spec = R.delivery_rules(pmesh).spec_for(ax, shapes[name], fb)
        jspec = JR.delivery_rules(jmesh).spec_for(ax, shapes[name], jfb)
        assert spec == tuple(jspec) and fb == jfb, (name, spec, jspec)
    # the microbatch splits its groups over "data" exactly when they divide
    split = R.delivery_rules(pmesh).spec_for(DELIVERY_ARRAYS["x"],
                                             shapes["x"])[0]
    assert split == ("data" if groups % 2 == 0 else None)


@pytest.mark.parametrize("mesh", ["2x2x2", "16x16"])
def test_activation_rules_match_the_reference(mesh):
    jmesh, pmesh = _meshes(mesh)
    cases = [(("batch", None, "embed"), (32, 128, 4096)),
             (("batch", None, "heads", None), (32, 128, 32, 128)),
             (("batch", None, "kv_heads", None), (4, 128, 8, 128)),
             (("batch", None, "vocab"), (16, 128, 102400)),
             (("batch", "kv_seq", "ffn"), (6, 64, 11008))]
    for ax, shape in cases:
        fb, jfb = [], []
        spec = R.activation_rules(pmesh).spec_for(ax, shape, fb)
        jspec = JR.activation_rules(jmesh).spec_for(ax, shape, jfb)
        assert spec == tuple(jspec) and fb == jfb, (ax, spec, jspec)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_rules_cover_every_param(arch):
    """Every param leaf gets a sharding and its placements on a (1, 1)
    mesh (tests/test_distributed.py:174)."""
    model = Model(get_config(arch), device="cpu")
    mesh = R.MeshShape(("data", "model"), (1, 1))
    fallbacks = []
    sh = R.tree_shardings(R.param_rules(mesh, fsdp=True), model.axes(),
                          model.abstract_params(), fallbacks)
    n_params = len(list(_leaves(model.abstract_params())))
    shardings = [s for _, s in _leaves(sh)]
    assert n_params == len(shardings)
    assert all(len(s.placements) == 2 for s in shardings)
    assert fallbacks == []


def test_param_axes_follow_every_schema_leaf():
    """``ParamDef`` checks its axes against its shape, and every leaf of
    every arch's schema carries one name (or None) a dim."""
    from repro_torch.models.base import ParamDef

    with pytest.raises(AssertionError):
        ParamDef((2, 3), ("embed",))
    for arch in ARCHS:
        model = Model(get_config(arch), device="cpu")
        shapes = model.abstract_params()
        for path, ax in _leaves(model.axes()):
            assert len(ax) == len(_get(shapes, path).shape), (arch, path)


def test_placements_split_nested_axes_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = R.MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert R.placements(mesh, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert R.placements(mesh, (None, None)) == (Replicate(),) * 3
    rules = R.param_rules(mesh)
    assert rules.placements_for(("vocab", "embed"), (64, 8)) == (
        Shard(1), Shard(1), Shard(0))
    with pytest.raises(ValueError, match="out of mesh order"):
        R.placements(mesh, (("data", "pod"),))


def test_hint_spec_drops_absent_names_and_undivided_dims():
    mesh = R.MeshShape(("pod", "data", "model"), (2, 2, 4))
    assert hint_spec(mesh, (8, 16, 3), ("dp", None, "model")) == (
        ("pod", "data"), None, None)
    assert hint_spec(mesh, (6, 8), ("dp", "model")) == (None, "model")
    assert hint_spec(mesh, (8, 8), ("expert", ("data", "model"))) == (
        None, ("data", "model"))
    assert hint_spec(mesh, (8, 8, 8), ("data",)) == ("data", None, None)
    two = R.MeshShape(("data", "model"), (2, 2))
    assert hint_spec(two, (4,), ("dp",)) == ("data",)


def test_production_shape():
    assert M.production_shape() == R.MeshShape(("data", "model"), (16, 16))
    assert M.production_shape(multi_pod=True) == R.MeshShape(
        ("pod", "data", "model"), (2, 16, 16))


def test_a_mesh_needs_an_initialised_world():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        M.single_device_mesh("cpu")


def test_mesh_context_is_scoped_and_per_thread():
    assert ambient_mesh() is None
    seen = []
    with M.mesh_context("outer"):
        with M.mesh_context("inner"):
            assert ambient_mesh() == "inner"
            t = threading.Thread(target=lambda: seen.append(ambient_mesh()))
            t.start()
            t.join()
        assert ambient_mesh() == "outer"
    assert ambient_mesh() is None and seen == [None]
    x = torch.ones(3)
    assert hint(x, "dp") is x


@pytest.fixture
def world1(tmp_path):
    """A world of one gloo rank, destroyed after the test."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield M.single_device_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_functions_check_the_world(world1):
    assert world1.mesh_dim_names == ("data", "model")
    assert tuple(world1.shape) == (1, 1)
    with pytest.raises(ValueError, match="needs 4 ranks; the world has 1"):
        M.make_debug_mesh(2, 2, device_type="cpu")
    with pytest.raises(ValueError, match="needs 8 ranks"):
        M.make_debug_mesh(2, 2, pods=2, device_type="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        M.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        M.make_production_mesh(multi_pod=True, device_type="cpu")


def _dt(mesh, t):
    return R.shard_tensor(t, mesh, (None,) * t.dim())


def _wrappers():
    from repro_torch.kernels import gemm, ops

    x = torch.ones(2, 4, 6)
    gidx = torch.zeros(2, dtype=torch.int32)
    cores = torch.ones(3, 6, 6)
    augs = torch.ones(3, 6, 5)
    toks = torch.zeros(2, 4, 3, dtype=torch.int32)
    perms = torch.zeros(3, 10, dtype=torch.int32)
    tables = torch.ones(3, 10, 4)
    heads = torch.ones(3, 6, 10)
    return {
        "morph_rows_grouped": (ops.morph_rows_grouped, (x, gidx, cores, 1)),
        "aug_conv_forward_grouped": (ops.aug_conv_forward_grouped,
                                     (x, gidx, augs)),
        "token_morph_grouped": (ops.token_morph_grouped, (toks, gidx, perms)),
        "aug_embed_grouped": (ops.aug_embed_grouped, (toks, gidx, tables)),
        "aug_embed_rows_grouped": (ops.aug_embed_rows_grouped,
                                   (gidx, gidx, tables)),
        "lm_head_rows_grouped": (ops.lm_head_rows_grouped,
                                 (torch.ones(2, 6), gidx, heads)),
        "check_operands": (lambda a, b: gemm.check_operands(
            "k", a, b, (torch.float32,)), (x, augs)),
    }


@pytest.mark.parametrize("entry", list(_wrappers()))
def test_kernel_wrappers_refuse_a_dtensor(world1, entry):
    """A DTensor never reaches a kernel: each entry point refuses one (in
    any operand position) with an error that names ``to_local()``, and
    takes the plain tensors."""
    fn, args = _wrappers()[entry]
    if entry != "check_operands":
        fn(*args)
    for i, a in enumerate(args):
        if not isinstance(a, torch.Tensor):
            continue
        bad = list(args)
        bad[i] = _dt(world1, a)
        with pytest.raises(TypeError, match=r"to_local\(\)"):
            fn(*bad)


def test_train_step_on_one_rank_mesh_matches_unsharded(world1):
    from repro_torch.launch.steps import (TrainHParams, make_train_step,
                                          shard_train_state)
    from repro_torch.optim import adamw

    cfg = get_smoke_config("deepseek_7b")
    model = Model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)),
                                dtype=torch.int32)
             for k in ("tokens", "targets")}
    step = make_train_step(model, TrainHParams(microbatch=2))
    params = model.init(0)
    ref_p, _, ref_m = step(params, adamw.init_state(params), batch)
    params = model.init(0)
    sp, so = shard_train_state(model, params, adamw.init_state(params),
                               world1)
    with M.mesh_context(world1):
        out_p, _, out_m = step(sp, so, batch)
    assert float(out_m["loss"]) == pytest.approx(float(ref_m["loss"]),
                                                 rel=1e-6)
    assert float(out_m["grad_norm"]) == pytest.approx(
        float(ref_m["grad_norm"]), rel=1e-6)
    ref = dict(adamw.named_leaves(ref_p))
    for n, p in adamw.named_leaves(out_p):
        torch.testing.assert_close(p.full_tensor(), ref[n], rtol=0,
                                   atol=1e-7)


def test_engine_on_one_rank_mesh_gives_the_same_bits(world1):
    import repro_torch.core as core
    from repro_torch.runtime import DeliveryRequest, MoLeDeliveryEngine

    rng = np.random.default_rng(0)
    geom = core.ConvGeometry(alpha=2, beta=4, m=6, p=3)
    reg = core.SessionRegistry(geom, kappa=2, capacity=4)
    for i in range(4):
        k = rng.standard_normal((2, 4, 3, 3)).astype(np.float32) / 4
        reg.register(f"t{i}", k, seed=100 + i)
    reqs = [DeliveryRequest(f"t{i % 4}", rng.standard_normal(
        (2, 2, 6, 6)).astype(np.float32)) for i in range(6)]

    def run(sharded):
        eng = MoLeDeliveryEngine(reg, "cpu")
        with M.mesh_context(world1) if sharded else contextlib.nullcontext():
            rids = [eng.submit(r) for r in reqs]
            done = eng.flush()
        return [done[r] for r in rids]

    for a, b in zip(run(True), run(False)):
        np.testing.assert_array_equal(a, b)


def test_moe_on_one_rank_mesh_equals_the_dense_form(world1):
    """On one rank the local tokens and experts are all of them, and the
    capacity is the dense form's."""
    from repro_torch.models import blocks

    cfg = get_smoke_config("deepseek_moe_16b")
    rng = np.random.default_rng(3)
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_routed

    def w(*s):
        return torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[-2]))
                                .astype(np.float32))

    fs = m.n_shared * f
    p = {"router": w(d, e), "wg": w(e, d, f), "wu": w(e, d, f),
         "wd": w(e, f, d), "shared": {"wi_gate": w(d, fs), "wi_up": w(d, fs),
                                      "wo": w(fs, d)}}
    x = torch.from_numpy(rng.standard_normal((2, 8, d)).astype(np.float32))
    dense = blocks.apply_moe(p, x, cfg)
    placed = {k: ({j: R.shard_tensor(u, world1, (None,) * u.ndim)
                   for j, u in v.items()} if isinstance(v, dict)
                  else R.shard_tensor(v, world1, (None,) * v.ndim))
              for k, v in p.items()}
    rows = blocks.apply_moe(placed, x, cfg)     # this rank's own tokens
    assert type(rows) is torch.Tensor
    torch.testing.assert_close(rows, dense, rtol=0, atol=1e-6)


def test_compressed_psum_on_one_rank(world1):
    from repro_torch.optim.compress import compressed_psum, dequantize_int8, \
        quantize_int8

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(64)
                         .astype(np.float32))
    got = compressed_psum(x, "data", world1)
    torch.testing.assert_close(got, dequantize_int8(*quantize_int8(x)),
                               rtol=0, atol=0)
    assert float((got - x).abs().max()) < 0.05


def test_shard_tree_keeps_a_param_tree(world1):
    from torch.distributed.tensor import DTensor

    from repro_torch.models.base import ParamTree
    from repro_torch.optim import adamw

    model = Model(dataclasses.replace(get_smoke_config("deepseek_7b")),
                  device="cpu")
    params = model.init(0)
    fb = []
    out = R.shard_tree(R.param_rules(world1), model.axes(), params, fb)
    assert isinstance(out, ParamTree) and fb == []
    for (n, a), (_, b) in zip(adamw.named_leaves(out),
                              adamw.named_leaves(params)):
        assert isinstance(a, DTensor) and torch.equal(a.full_tensor(), b), n
    counts = collections.Counter(len(a.placements)
                                 for _, a in adamw.named_leaves(out))
    assert counts == {2: len(adamw.named_leaves(params))}


def test_moe_train_step_on_one_rank_mesh_matches_unsharded(world1):
    """deepseek_moe_16b smoke: under the mesh its MoE layers take the
    expert-parallel form (one rank: every token and expert, the dense
    form's capacity), and the step matches the unsharded one."""
    from repro_torch.launch.steps import (TrainHParams, make_train_step,
                                          shard_train_state)
    from repro_torch.models import blocks
    from repro_torch.optim import adamw

    model = Model(get_smoke_config("deepseek_moe_16b"), device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, model.cfg.vocab, (4, 16)),
                                dtype=torch.int32)
             for k in ("tokens", "targets")}
    step = make_train_step(model, TrainHParams(microbatch=2))
    params = model.init(0)
    ref_p, _, ref_m = step(params, adamw.init_state(params), batch)
    params = model.init(0)
    sp, so = shard_train_state(model, params, adamw.init_state(params),
                               world1)
    calls = []
    real = blocks._apply_moe_sharded

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    blocks._apply_moe_sharded = spy
    try:
        with M.mesh_context(world1):
            out_p, _, out_m = step(sp, so, batch)
    finally:
        blocks._apply_moe_sharded = real
    assert calls
    assert float(out_m["loss"]) == pytest.approx(float(ref_m["loss"]),
                                                 rel=1e-6)
    assert float(out_m["grad_norm"]) == pytest.approx(
        float(ref_m["grad_norm"]), rel=1e-6)
    ref = dict(adamw.named_leaves(ref_p))
    for n, p in adamw.named_leaves(out_p):
        torch.testing.assert_close(p.full_tensor(), ref[n], rtol=0,
                                   atol=1e-7)


def test_compute_view_gathers_each_block_where_it_runs(world1):
    """The train step's compute view leaves every block deferred, and
    ``apply_stack`` gathers each inside its recomputed part: under remat a
    block is gathered for its forward and again for its backward (so no
    gathered weight is kept between the two), once without remat."""
    from repro_torch.launch.steps import TrainHParams, make_train_step, \
        shard_train_state
    from repro_torch.models import stack
    from repro_torch.optim import adamw
    from repro_torch.sharding import spmd
    from torch.distributed.tensor import DTensor

    model = Model(get_smoke_config("deepseek_7b"), device="cpu")
    params = model.init(0)
    sp, so = shard_train_state(model, params, adamw.init_state(params),
                               world1)
    view = spmd.compute_view(sp, world1)
    assert all(isinstance(b, spmd.Deferred) for b in view["blocks"])
    assert type(view["embed"]) is torch.Tensor
    assert isinstance(view["head"], DTensor)
    block = spmd.in_use(view["blocks"][0])
    assert type(block["mix"]["wq"]) is torch.Tensor
    torch.testing.assert_close(block["mix"]["wq"],
                               params["blocks"][0]["mix"]["wq"])

    real = spmd.in_use
    batch = {k: torch.zeros((2, 8), dtype=torch.int32)
             for k in ("tokens", "targets")}
    for remat, per_block in ((True, 2), (False, 1)):
        gathered = []

        def watch(p):
            if isinstance(p, spmd.Deferred):
                gathered.append(p)
            return real(p)

        stack.in_use = watch
        try:
            with M.mesh_context(world1):
                make_train_step(model, TrainHParams(remat=remat))(sp, so,
                                                                  batch)
        finally:
            stack.in_use = real
        assert len(gathered) == per_block * len(view["blocks"]), remat
