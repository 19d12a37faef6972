"""The modality frontends in the port (``repro_torch.models.frontends`` and
their wiring in ``models/transformer.py`` and ``launch/serve.py``) against
the JAX package, at ``reduced`` widths with the JAX package's init
converted and inputs drawn with numpy.

* The shape specs and the random-embedding draws: JAX's shapes and dtypes,
  the 0.02 scale, the generator's device and reproducibility.
* ``param_specs``: an audio model has no embedding and always a head; a
  vision model keeps its tied embedding.  ``embed_inputs``: frames pass
  through, patches go ahead of the embedded tokens.
* internvl2-1b (vision patches): ``forward``, ``prefill`` of patches +
  prompt and two teacher-forced ``decode_step``s from position P + S, and
  ``serve(patches=)`` against JAX within rtol 2e-3 plus 1e-3 of the largest
  logit (``tests/test_torch_serve.py``'s tolerance); within the port,
  prefill + decode reproduce forward to ``tests/test_decode.py``'s
  tolerances.
* hubert-xlarge (audio frames, bidirectional, encoder-only): ``forward``
  against JAX at the same tolerance; ``serve`` refuses it.

JAX is imported inside the tests that use it.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.common.arch_config import reduced
from repro_torch.launch import serve as serve_mod
from repro_torch.models import frontends
from repro_torch.models import transformer as T

CROSS_RTOL, CROSS_ATOL_REL = 2e-3, 1e-3
PREFILL_RTOL, PREFILL_ATOL, DECODE_ATOL = 2e-3, 2e-4, 2e-3


def _cross_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=CROSS_RTOL,
                               atol=CROSS_ATOL_REL * np.abs(want).max())


def _cfgs(name):
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    return jreduced(jconfigs.get(name)), reduced(configs.get(name))


def _converted(cfg_j, seed):
    import jax
    from repro.models import transformer as JT
    from repro_torch.convert import to_torch
    pj = JT.init(cfg_j, jax.random.PRNGKey(seed))
    return pj, to_torch(jax.tree.map(np.asarray, pj))


def _embeds(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.02).astype(
        np.float32)


def _leaf_shapes(tree, path):
    """(JAX key path, shape) of every spec leaf, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_shapes(tree[k], path + f"[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _leaf_shapes(v, path + f"[{i}]")]
    return [(path, tree.shape)]


def test_specs_and_draws_match_jax():
    import jax
    import jax.numpy as jnp
    from repro.models import frontends as jfront
    for name in ("hubert-xlarge", "internvl2-1b"):
        cfg_j, cfg_t = _cfgs(name)
        for fn, args in (("audio_frames_spec", (3, 11)),
                         ("vision_patches_spec", (3,))):
            want = getattr(jfront, fn)(cfg_j, *args)
            got = getattr(frontends, fn)(cfg_t, *args)
            assert tuple(got.shape) == tuple(want.shape)
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    cfg = configs.get("internvl2-1b")
    for fn, args, shape in (
            ("fake_audio_frames", (cfg, 2, 300), (2, 300, 896)),
            ("fake_vision_patches", (cfg, 4), (4, 256, 896))):
        a = getattr(frontends, fn)(torch.Generator().manual_seed(0), *args)
        b = getattr(frontends, fn)(torch.Generator().manual_seed(0), *args)
        j = getattr(jfront, fn)(jax.random.PRNGKey(0), *args)
        assert tuple(a.shape) == shape == tuple(j.shape)
        assert torch.equal(a, b) and a.dtype == torch.float32
        assert abs(float(a.std()) - 0.02) < 1e-3
        assert abs(float(np.asarray(j).std()) - 0.02) < 1e-3
    bf = frontends.fake_vision_patches(torch.Generator().manual_seed(0), cfg,
                                       1, dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and bf.device.type == "cpu"


def test_param_specs_and_embed_inputs_match_jax():
    import jax
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    from repro.models import transformer as JT
    for name in ("hubert-xlarge", "internvl2-1b"):
        cfg_j, cfg_t = _cfgs(name)
        sj = JT.param_specs(cfg_j)
        st = T.param_specs(cfg_t)
        assert sorted(st) == sorted(sj)
        assert ("embed" in st) == (name == "internvl2-1b")
        assert ("head" in st) == (name == "hubert-xlarge")
        want = sorted((jax.tree_util.keystr(p), s.shape) for p, s in
                      jax.tree_util.tree_flatten_with_path(
                          sj, is_leaf=jlayers.is_spec)[0])
        assert sorted(_leaf_shapes(st, "")) == want
    # embed_inputs: frames as they are; patches ahead of the tokens
    cfg_j, cfg_t = _cfgs("internvl2-1b")
    pj, pt = _converted(cfg_j, 0)
    toks = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (2, 5))
    patches = _embeds((2, cfg_t.n_frontend_tokens, cfg_t.d_model), 2)
    got = T.embed_inputs(pt, cfg_t, {"tokens": torch.from_numpy(toks),
                                     "patches": torch.from_numpy(patches)})
    want = JT.embed_inputs(pj, cfg_j, {"tokens": jnp.asarray(toks),
                                       "patches": jnp.asarray(patches)})
    assert tuple(got.shape) == (2, cfg_t.n_frontend_tokens + 5,
                                cfg_t.d_model)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    no_patch = T.embed_inputs(pt, cfg_t, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(no_patch.numpy(),
                                  got[:, cfg_t.n_frontend_tokens:].numpy())
    cfg_a = reduced(configs.get("hubert-xlarge"))
    frames = torch.from_numpy(_embeds((2, 7, cfg_a.d_model), 3))
    assert T.embed_inputs({}, cfg_a, {"frames": frames}) is frames


def test_vision_model_matches_jax():
    """internvl2-1b: forward, prefill of patches + prompt, two forced decode
    steps from position P + S, and serve(patches=), against JAX."""
    import jax.numpy as jnp
    from repro.models import transformer as JT
    cfg_j, cfg_t = _cfgs("internvl2-1b")
    pj, pt = _converted(cfg_j, 0)
    b, s, n_p = 2, 30, cfg_t.n_frontend_tokens
    toks = np.random.default_rng(4).integers(0, cfg_j.vocab_size, (b, s + 2))
    patches = _embeds((b, n_p, cfg_t.d_model), 5)
    jb = {"patches": jnp.asarray(patches)}
    tb = {"patches": torch.from_numpy(patches)}
    fj, _ = JT.forward(pj, cfg_j, {**jb, "tokens": jnp.asarray(toks)})
    ft = T.forward(pt, cfg_t, {**tb, "tokens": torch.from_numpy(toks)})
    assert tuple(ft.shape) == (b, n_p + s + 2, cfg_t.vocab_size)
    _cross_close(ft, fj)
    max_seq = n_p + s + 4
    lj, cj = JT.prefill(pj, cfg_j, {**jb, "tokens": jnp.asarray(toks[:, :s])},
                        max_seq=max_seq)
    lt, ct = T.prefill(pt, cfg_t, {**tb, "tokens": torch.from_numpy(
        toks[:, :s])}, max_seq=max_seq)
    _cross_close(lt, lj)
    for i in range(2):
        step = toks[:, s + i: s + i + 1]
        dj, cj = JT.decode_step(pj, cfg_j, {"tokens": jnp.asarray(step)}, cj,
                                jnp.int32(n_p + s + i))
        dt, ct = T.decode_step(pt, cfg_t, {"tokens": torch.from_numpy(step)},
                               ct, n_p + s + i)
        _cross_close(dt, dj)
        # within the port, decode reproduces forward (test_decode.py)
        assert float((dt[:, 0] - ft[:, n_p + s + i]).abs().max()) \
            < DECODE_ATOL
    np.testing.assert_allclose(lt.numpy(), ft[:, :n_p + s].numpy(),
                               rtol=PREFILL_RTOL, atol=PREFILL_ATOL)
    res = serve_mod.serve(cfg_t, pt, torch.from_numpy(toks[:, :s]), 3,
                          device="cpu",
                          forced_tokens=torch.from_numpy(toks[:, s:]),
                          patches=torch.from_numpy(patches))
    _cross_close(res.prefill_logits, lj[:, -1])
    _cross_close(res.step_logits[1], dj[:, 0])
    with pytest.raises(ValueError, match="patches"):
        serve_mod.serve(cfg_t, pt, torch.from_numpy(toks[:, :s]), 2,
                        device="cpu")


def test_audio_model_matches_jax_and_is_refused_by_serve():
    """hubert-xlarge: frames in, bidirectional attention, a head of 504
    cluster units; no decode step."""
    import jax.numpy as jnp
    from repro.models import transformer as JT
    cfg_j, cfg_t = _cfgs("hubert-xlarge")
    assert not cfg_t.causal and cfg_t.frontend == "audio_frames"
    pj, pt = _converted(cfg_j, 0)
    frames = _embeds((2, 45, cfg_t.d_model), 6)
    lj, aux_j = JT.forward(pj, cfg_j, {"frames": jnp.asarray(frames)})
    lt, aux_t = T.forward(pt, cfg_t, {"frames": torch.from_numpy(frames)},
                          return_aux=True)
    assert tuple(lt.shape) == (2, 45, cfg_t.vocab_size)
    _cross_close(lt, lj)
    assert float(aux_t) == float(aux_j) == 0.0
    # bidirectional: the first frame's logits see the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    lm = T.forward(pt, cfg_t, {"frames": torch.from_numpy(moved)})
    assert float((lm[:, 0] - lt[:, 0]).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="encoder-only"):
        serve_mod.serve(cfg_t, pt, torch.zeros(1, 4, dtype=torch.int64), 2,
                        device="cpu")
