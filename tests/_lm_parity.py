"""Token parity between the port's and the reference's LM generations that
does not depend on the machine (shared by the port's LM tests).

A CPU matmul sums in an order that depends on the machine (instruction
set, threads, shapes), so two logits that are nearly tied may swap on one
machine and not on another.  Tokens are compared only where the
reference's top-1/top-2 logit gap exceeds ``GAP_MARGIN`` x max|logit| of
that position: five times the largest logit difference the port's fp32
logit checks admit (2e-5 x max), so above it no admitted difference can
change the argmax.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np

from repro.models import stack as jS

GAP_MARGIN = 1e-4
RTOL = 1e-5


def decided(logits) -> np.ndarray:
    """Positions whose top-1/top-2 gap exceeds ``GAP_MARGIN`` x max|logit|
    of that position: there the argmax is the same on every machine."""
    lg = np.asarray(logits, np.float64)
    top2 = np.sort(lg, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > GAP_MARGIN * np.abs(lg).max(-1)


def ref_logits(jparams, jcfg, prompts, gens, ctx=None) -> list[np.ndarray]:
    """The reference's logits at the positions that predicted ``gen``,
    teacher-forced on each ``prompt + gen[:-1]`` (raw token ids); ``ctx``
    is a vlm's patch stream or an audio model's frames, one row per
    sequence.

    A dense model: one forward over all sequences (one batch, zero-padded
    at the end, which a causal model does not see).  An MoE model routes
    each call with its own capacity (``moe_capacity`` of the call's
    tokens), so the logits come from the calls the decode lane makes: a
    prefill of each prompt alone, then one decode step of that sequence
    alone per generated token (the lane vmaps a B = 1 step over its
    rows)."""
    if jcfg.moe is not None:
        return [_ref_logits_alone(jparams, jcfg, p, g)
                for p, g in zip(prompts, gens)]
    P, G = len(prompts[0]), max(len(g) for g in gens)
    seqs = np.zeros((len(gens), P + G - 1), np.int32)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        seqs[i, :P + len(g) - 1] = np.concatenate([p, g[:-1]])
    if jcfg.family == "audio":
        from repro.models import whisper as jW
        lg = jW.forward(jparams, jcfg, ctx, jnp.asarray(seqs))[0]
    else:
        lg = jS.forward(jparams, jcfg, jnp.asarray(seqs), ctx=ctx)[0]
    lg = np.asarray(lg, np.float64)
    return [lg[i, P - 1:P - 1 + len(g)] for i, g in enumerate(gens)]


_JITTED = {}


def jitted(jcfg, max_len: int):
    """The reference's prefill into caches of ``max_len`` and its decode
    step, jitted once per config and cache length."""
    import jax

    from repro.models.api import Model as JModel

    key = (jcfg, max_len)
    if key not in _JITTED:
        jm = JModel(jcfg)
        _JITTED[key] = (
            jax.jit(lambda p, toks: jm.prefill(p, {"tokens": toks}, max_len)),
            jax.jit(jm.decode),
        )
    return _JITTED[key]


def _ref_logits_alone(jparams, jcfg, prompt, gen, max_len: int = 64) -> np.ndarray:
    """One sequence through the reference's prefill (B = 1) and a decode
    step (B = 1) per token of ``gen[:-1]``, in caches of ``max_len``."""
    P = len(prompt)
    assert P + len(gen) <= max_len
    prefill, decode = jitted(jcfg, max_len)
    lg, caches = prefill(jparams, jnp.asarray(prompt, jnp.int32)[None])
    out = [lg[0, -1]]
    for j, tok in enumerate(np.asarray(gen)[:-1]):
        lg, caches = decode(jparams, jnp.full((1, 1), tok, jnp.int32),
                            jnp.asarray(P + j), caches)
        out.append(lg[0, -1])
    return np.asarray(jnp.stack(out), np.float64)


def hold_lane(jparams, jcfg, prompts, got, want, ctx=None) -> int:
    """Hold generations ``got`` against the reference's ``want`` (sequences
    of unmorphed token arrays, one per request) without asking two
    machines to break a near-tie the same way:

      * token for token up to the first step at which the reference's own
        logits (its teacher-forced forward on ``want``) have a top-1/top-2
        gap under ``GAP_MARGIN`` x max|logit|; such steps are rare (at most
        one in ten);
      * every token of ``got`` is, on its own prefix, within the margin of
        the reference forward's maximum, so after a near-tie it is still a
        greedy decode under the reference's model.

    ``ctx`` is a vlm's patches or an audio model's frames
    (:func:`ref_logits`).  Returns the
    number of steps held token for token.
    """
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    n_steps = n_ties = held = 0
    for g, w, lg in zip(got, want,
                        ref_logits(jparams, jcfg, prompts, want, ctx)):
        ok = decided(lg)
        first = len(w) if ok.all() else int(np.argmin(ok))
        np.testing.assert_array_equal(g[:first], w[:first])
        n_steps, n_ties = n_steps + len(w), n_ties + int((~ok).sum())
        held += first
    assert n_ties * 10 <= n_steps, f"{n_ties} near-ties in {n_steps} steps"
    for g, lg in zip(got, ref_logits(jparams, jcfg, prompts, got, ctx)):
        slack = lg.max(-1) - lg[np.arange(len(g)), g]
        assert (slack <= GAP_MARGIN * np.abs(lg).max(-1)).all(), slack
    return held


def ref_layers(tree, cfg) -> list:
    """A reference tree of per-layer entries (parameters or caches) in the
    port's layer order, ``cfg.layer_kinds()``: ``tree["prefix"]``, then
    slice ``g`` of ``tree["blocks"][f"b{i}"]`` for layer ``g * P + i`` of
    the scanned pattern (P kinds), then ``tree["suffix"]``; leaves as
    numpy arrays."""
    import jax

    def take(node, g=None):
        return jax.tree.map(
            lambda a: np.asarray(a if g is None else a[g]), node)

    P = len(cfg.block_pattern)
    return ([take(c) for c in tree.get("prefix", [])]
            + [take(tree["blocks"][f"b{i}"], g)
               for g in range(cfg.n_groups) for i in range(P)]
            + [take(c) for c in tree.get("suffix", [])])


def close(got, want, rtol=RTOL):
    """Within ``rtol`` relative, with an absolute floor of ``rtol`` times
    the array's largest magnitude (entries near zero carry the absolute
    error of their neighbours)."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want,
        rtol=rtol, atol=rtol * float(np.abs(want).max()),
    )


def _logit_runs(model, params, tokens, jtokens, max_len):
    """The logits of ``forward``, ``prefill`` and one teacher-forced decode
    step per entry of ``jtokens`` through the port's per-tenant serving
    steps, and the caches after the last step."""
    import torch

    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import stack as tS

    S = tokens.shape[1]
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    out = [tS.forward(params, model.cfg, torch.from_numpy(tokens))[0]]
    lg, caches = prefill(params, {"tokens": torch.from_numpy(tokens)},
                         model.init_cache(tokens.shape[0], max_len))
    out.append(lg)
    for i, tok in enumerate(jtokens):
        lg, caches = decode(params, torch.from_numpy(np.array(tok)), S + i,
                            caches)
        out.append(lg)
    return [o.double().numpy() for o in out], caches


def hold_model(cfg, jcfg, tokens, n_decode: int, seed: int = 0,
               tol: float | None = None):
    """``forward``, ``prefill`` and ``n_decode`` decode steps of the port's
    per-tenant serving steps, teacher forced with the reference's greedy
    tokens, against the reference's: the logits of every call within
    ``tol`` of max|logit|, and every cache leaf after the last step (K/V,
    MLA's latent ``ckv`` and roped ``kr``; the position each slot holds,
    ``pos``, exactly).

    ``tol``, unless given, is RTOL, or four times the reference's own
    largest departure in the run from the same model evaluated with
    float64 products (the port with ``dtype="float64"``; its norms, RoPE
    angles, attention scores and MoE router stay in fp32, as the
    reference's do) where that is larger: two fp32 summation orders agree
    no closer than each of them is to that evaluation, and a port held so
    departs from it at most five times as far as the reference.  It is
    returned, and must stay under 2e-4."""
    import jax
    import torch

    from repro.models.api import Model as JModel
    from repro_torch.models import Model, params_from_jax

    jparams = JModel(jcfg).init(jax.random.key(seed))
    np_params = jax.tree.map(np.asarray, jparams)
    B, S = tokens.shape
    max_len = S + n_decode + 1
    prefill, decode = jitted(jcfg, max_len)
    want = [jax.jit(lambda p, t: jS.forward(p, jcfg, t)[0])(
        jparams, jnp.asarray(tokens))]
    jlog, jc = prefill(jparams, jnp.asarray(tokens))
    want.append(jlog)
    jtokens = []
    for i in range(n_decode):
        jtokens.append(np.asarray(jnp.argmax(jlog[:, 0], -1), np.int32)[:, None])
        jlog, jc = decode(jparams, jnp.asarray(jtokens[-1]),
                          jnp.asarray(S + i), jc)
        want.append(jlog)
    want = [np.asarray(w, np.float64) for w in want]

    if tol is None:
        c64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
        exact, _ = _logit_runs(
            Model(c64, "cpu"),
            params_from_jax(jax.tree.map(lambda a: a.astype(np.float64),
                                         np_params), c64, "cpu"),
            tokens, jtokens, max_len)
        tol = max([RTOL] + [4 * np.abs(w - e).max() / np.abs(e).max()
                            for w, e in zip(want, exact)])
    assert tol < 2e-4, tol
    tparams = params_from_jax(np_params, cfg, "cpu")
    assert len(tparams["blocks"]) == cfg.n_layers
    got, tc = _logit_runs(Model(cfg, "cpu"), tparams, tokens, jtokens,
                          max_len)
    for g, w in zip(got, want):
        close(g, w, tol)
    for c, jb in zip(tc["blocks"], ref_layers(jc, jcfg)):
        assert sorted(c) == sorted(jb)
        for name, x in c.items():
            if name == "pos":
                assert (x == torch.from_numpy(jb["pos"])[None]).all()
            else:
                close(x, jb[name], tol)
    return tc, tol
