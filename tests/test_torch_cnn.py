"""The port's VGG (``repro_torch.models.cnn``) on the CPU, against the JAX
reference (``repro.models.cnn``) on the same numpy inputs, weights and
tenant secrets, at ``vgg_small`` in fp32: logits on the plain and the
Aug-Conv path, parameter gradients of a cross-entropy loss, the Aug path
with the secret permutation absorbed against the plain path (paper eq. 5),
and no gradient into ``C^{ac}`` or the rows.

Bounds, relative to the largest magnitude compared: 1e-5 for logits and
gradients of one function computed by both packages (fp32, sums in other
orders), 1e-4 where the port's Aug path is held against its plain path (a
dense 768-term product against a 27-term convolution).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DataProvider as JProvider  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import DataProvider, conv_reference, unroll_batch  # noqa: E402
from repro_torch.kernels import aug_gemm, morph_rows  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

SAME_FN = 1e-5
AUG_VS_PLAIN = 1e-4
B = 4


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bound = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def _numpy_tree(cfg, rng):
    """Weights in the reference's tree layout and scales, drawn with numpy
    (nonzero biases, so every bias is held too)."""
    k = cfg.kernel
    convs = [{"w": (rng.standard_normal((co, ci, k, k))
                    * np.sqrt(2.0 / (ci * k * k))).astype(np.float32),
              "b": (0.1 * rng.standard_normal(co)).astype(np.float32)}
             for ci, co in cfg.conv_shapes()]
    feat = cfg.stages[-1][-1] * (cfg.image_size // 2 ** len(cfg.stages)) ** 2
    head = {"w": (rng.standard_normal((feat, cfg.classes))
                  / np.sqrt(feat)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(cfg.classes)).astype(np.float32)}
    return {"convs": convs, "head": head}


@pytest.fixture(scope="module")
def setup():
    """One weight tree for both packages, one tenant's secrets in both
    (same numpy seed), seeded images and labels."""
    jcfg, cfg = jcnn.vgg_small(), cnn.vgg_small()
    rng = np.random.default_rng(0)
    tree = _numpy_tree(jcfg, rng)
    params = cnn.params_from_jax(tree, "cpu")
    geom = cfg.first_geom
    jprov = JProvider(jcfg.first_geom, kappa=1, seed=0)
    prov = DataProvider(geom, kappa=1, seed=0)
    kernels = np.asarray(jcnn.first_layer_kernels(tree, jcfg))
    jaug = jprov.build_aug_conv(kernels)
    aug = prov.build_aug_conv(kernels)
    x = rng.standard_normal((B, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    y = rng.integers(0, cfg.classes, B)
    rows = np.array(jprov.morph_batch(jnp.asarray(x)))
    return dict(jcfg=jcfg, cfg=cfg, tree=tree, params=params, jprov=jprov,
                prov=prov, jaug=jaug, aug=aug, x=x, y=y, rows=rows)


def _absorbed(params, perm):
    """Conv-0 output channels (and conv-1 input channels) permuted to absorb
    the Aug-Conv's channel randomisation (tests/test_vgg.py)."""
    p2 = {"convs": [dict(c) for c in params["convs"]], "head": params["head"]}
    p2["convs"][0]["b"] = params["convs"][0]["b"][perm]
    p2["convs"][1] = {"w": params["convs"][1]["w"][:, perm],
                      "b": params["convs"][1]["b"]}
    return p2


def test_vgg16_geometry_and_init_shapes():
    cfg = cnn.vgg16()
    assert len(cfg.conv_shapes()) == 13
    assert cfg.first_geom.in_features == 3 * 32 * 32
    assert cfg.conv_shapes() == jcnn.vgg16().conv_shapes()
    want = jax.eval_shape(lambda: jcnn.init(jax.random.key(0), jcnn.vgg16()))
    got = cnn.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(c["w"].shape) for c in got["convs"]] == [
        c["w"].shape for c in want["convs"]]
    assert tuple(got["head"]["w"].shape) == want["head"]["w"].shape


def test_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cnn.init(cnn.vgg_small(), 0)


def test_secrets_and_morph_match_reference(setup):
    """Same numpy seed, same secrets: the core and the channel permutation
    are byte-equal, the fused C^{ac} agrees after the fp32 cast (the two
    packages sum in other orders; at this size they agree to the byte), and
    K4's entry point equals the reference provider's morphed rows."""
    s = setup
    np.testing.assert_array_equal(s["prov"]._core.matrix, s["jprov"]._core.matrix)
    np.testing.assert_array_equal(s["aug"].channel_perm, s["jaug"].channel_perm)
    np.testing.assert_allclose(s["aug"].matrix, s["jaug"].matrix, rtol=1e-6,
                               atol=1e-6 * np.abs(s["jaug"].matrix).max())
    x = torch.from_numpy(s["x"])
    core = torch.from_numpy(s["prov"]._core.matrix)
    _close(morph_rows(unroll_batch(x), core, 1).numpy(), s["rows"], SAME_FN)
    _close(s["prov"].morph_batch(x).numpy(), s["rows"], SAME_FN)


@pytest.mark.parametrize("form", ["images", "rows"])
def test_plain_path_matches_reference(setup, form):
    s = setup
    x = s["x"] if form == "images" else s["x"].reshape(B, -1)
    want = jcnn.apply(s["tree"], jnp.asarray(x), s["jcfg"])
    got = cnn.apply(s["params"], torch.from_numpy(x), s["cfg"])
    assert got.shape == (B, s["cfg"].classes)
    _close(got.numpy(), want, SAME_FN)


def test_aug_path_matches_reference(setup):
    """Both packages on the same morphed rows and the same C^{ac}."""
    s = setup
    mat = s["jaug"].matrix
    want = jcnn.apply(s["tree"], jnp.asarray(s["rows"]), s["jcfg"],
                      aug_matrix=jnp.asarray(mat))
    n = aug_gemm.launches
    got = cnn.apply(s["params"], torch.from_numpy(s["rows"]), s["cfg"],
                    aug_matrix=torch.from_numpy(mat))
    assert aug_gemm.launches == n          # the CPU path launches nothing
    _close(got.numpy(), want, SAME_FN)


def test_aug_path_with_absorbed_perm_equals_plain(setup):
    """Eq. 5 through the whole network: Aug-VGG on morphed rows with the
    permutation absorbed computes plain VGG on the raw images; and K5's
    first-layer features are the convolution under the permutation."""
    s = setup
    cfg, prov = s["cfg"], s["prov"]
    x = torch.from_numpy(s["x"])
    plain = cnn.apply(s["params"], x, cfg)
    rows = prov.morph_batch(x)
    mat = torch.from_numpy(s["aug"].matrix)
    via_aug = cnn.apply(_absorbed(s["params"], s["aug"].channel_perm), rows,
                        cfg, aug_matrix=mat)
    _close(via_aug.numpy(), plain.numpy(), AUG_VS_PLAIN)
    geom = cfg.first_geom
    conv = conv_reference(x, cnn.first_layer_kernels(s["params"], cfg), geom)
    feats = aug_gemm(rows, mat).reshape(B, geom.beta, geom.n, geom.n)
    _close(feats.numpy(), conv[:, s["aug"].channel_perm].numpy(), AUG_VS_PLAIN)


def _jax_grads(tree, x, y, cfg, aug=None):
    def loss(p):
        lg = jcnn.apply(p, x, cfg, aug_matrix=aug)
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(lg.shape[0]), y])

    return jax.grad(loss)(tree)


@pytest.mark.parametrize("path", ["plain", "aug"])
def test_param_grads_match_jax(setup, path):
    s = setup
    aug = path == "aug"
    x = s["rows"] if aug else s["x"]
    mat = s["jaug"].matrix
    want = _jax_grads(s["tree"], jnp.asarray(x), jnp.asarray(s["y"]), s["jcfg"],
                      jnp.asarray(mat) if aug else None)
    model = cnn.VGG(s["params"], s["cfg"])
    logits = model(torch.from_numpy(x), torch.from_numpy(mat) if aug else None)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(s["y"])).backward()
    for i, (c, jc) in enumerate(zip(model.convs, want["convs"])):
        if aug and i == 0:
            assert c["w"].grad is None     # conv-0 weights are not on the path
            _close(c["b"].grad.numpy(), jc["b"], SAME_FN)
            continue
        for k in ("w", "b"):
            _close(c[k].grad.numpy(), jc[k], SAME_FN)
    for k in ("w", "b"):
        _close(model.head[k].grad.numpy(), want["head"][k], SAME_FN)


def test_aug_matrix_and_rows_receive_no_gradient(setup):
    """C^{ac} is a FIXED feature extractor and the rows are data: K5 sees
    neither with requires_grad, and neither gets a gradient."""
    s = setup
    mat = torch.from_numpy(s["aug"].matrix).requires_grad_()
    rows = s["prov"].morph_batch(torch.from_numpy(s["x"])).requires_grad_()
    out = cnn.apply(s["params"], rows, s["cfg"], aug_matrix=mat)
    assert not out.requires_grad           # params here are plain tensors
    model = cnn.VGG(s["params"], s["cfg"])
    model(rows, mat).sum().backward()
    assert mat.grad is None and rows.grad is None
    assert model.convs[0]["b"].grad is not None
    # The wrapper itself refuses an operand that requires grad.
    with pytest.raises(RuntimeError, match="no backward"):
        aug_gemm(rows, mat)
