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
import jax.numpy as jnp
import numpy as np

from repro.models import stack as jS

GAP_MARGIN = 1e-4


def decided(logits) -> np.ndarray:
    """Positions whose top-1/top-2 gap exceeds ``GAP_MARGIN`` x max|logit|
    of that position: there the argmax is the same on every machine."""
    lg = np.asarray(logits, np.float64)
    top2 = np.sort(lg, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > GAP_MARGIN * np.abs(lg).max(-1)


def ref_logits(jparams, jcfg, prompts, gens) -> list[np.ndarray]:
    """The reference's teacher-forced forward on each ``prompt + gen[:-1]``
    (raw token ids; one batch, zero-padded at the end, which a causal model
    does not see): the logits at the positions that predicted ``gen``."""
    P, G = len(prompts[0]), max(len(g) for g in gens)
    seqs = np.zeros((len(gens), P + G - 1), np.int32)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        seqs[i, :P + len(g) - 1] = np.concatenate([p, g[:-1]])
    lg = np.asarray(jS.forward(jparams, jcfg, jnp.asarray(seqs))[0],
                    np.float64)
    return [lg[i, P - 1:P - 1 + len(g)] for i, g in enumerate(gens)]


def hold_lane(jparams, jcfg, prompts, got, want) -> int:
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

    Returns the number of steps held token for token.
    """
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    n_steps = n_ties = held = 0
    for g, w, lg in zip(got, want, ref_logits(jparams, jcfg, prompts, want)):
        ok = decided(lg)
        first = len(w) if ok.all() else int(np.argmin(ok))
        np.testing.assert_array_equal(g[:first], w[:first])
        n_steps, n_ties = n_steps + len(w), n_ties + int((~ok).sum())
        held += first
    assert n_ties * 10 <= n_steps, f"{n_ties} near-ties in {n_steps} steps"
    for g, lg in zip(got, ref_logits(jparams, jcfg, prompts, got)):
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
