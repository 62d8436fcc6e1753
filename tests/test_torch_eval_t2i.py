"""Text-to-image evaluation in the port (``eval/text2img.py``,
``utils/comm.py`` and ``projects/dreamllm/eval_t2i.py``) against the JAX
package on the CPU.

The protocol functions run both packages with a deterministic stub
pipeline keyed by the chunk's seed integer (JAX hands its pipeline
``PRNGKey(seed)``, the port the integer) and a brightness scorer: the same
seeds, the same selected images bit for bit, the same FID through the
carried-across Inception (``inception_params`` in the helpers) within
``FID_REL``. The eval CLI runs on ``projects/dreamllm/configs/smoke.py``
from one saved state in both packages, with the same start latents
injected for each chunk's seed and the same Inception: selected images
within ``IMG_ATOL``, FID within ``FID_REL``. The DreamLLM-SDXL smoke recipe
runs in the port and raises in JAX (its entry always builds the SD-2.1
head pipeline).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.eval.text2img as jt2i
import dreamllm_tpu_torch.eval.text2img as pt2i
import dreamllm_tpu_torch.utils.comm as pcomm
from dreamllm_tpu_torch.bridge import from_jax
from dreamllm_tpu_torch.config import LazyArgumentParser
from dreamllm_tpu_torch.projects.dreamllm import eval_t2i as port_eval
from dreamllm_tpu_torch.projects.dreamllm import train as port_train
from dreamllm_tpu_torch.train.checkpoints import save_checkpoint
from tests._torch_port_helpers import inception_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = f"{ROOT}/projects/dreamllm/configs/smoke.py"
SDXL_SMOKE = f"{ROOT}/projects/dreamllm_sdxl/configs/smoke.py"
# float32 in both packages; the random Inception's features vary across
# images by about 1e-3 of their size (test_torch_fid.py), so FID, a
# difference of spreads, carries the features' float32 differences
# magnified about 1e3
FID_REL = 1e-3
IMG_ATOL = 1e-5


def _stub_images(seed: int, n: int, side: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).random((n, side, side, 3)).astype(np.float32)


def _jax_seed(rng) -> int:
    return int(np.asarray(jax.random.key_data(rng) if hasattr(jax.random, "key_data")
                          else rng)[-1])


def _brightness(images, captions):
    return np.asarray(images).mean(axis=(1, 2, 3))


def test_protocol_defaults_and_lncoco_loader(tmp_path):
    assert vars(pt2i.T2IProtocol()) == vars(jt2i.T2IProtocol())
    assert vars(pt2i.lncoco_protocol(batch_size=2)) == vars(jt2i.lncoco_protocol(batch_size=2))
    rows = [{"image_id": 42, "caption": "first narrative of image 42"},
            {"image_id": 42, "caption": "second narrative of image 42"},
            {"image_id": 7, "caption": "only narrative of image 7"},
            {"image_id": 9, "caption": "narrative of image 9"}]
    p = tmp_path / "lncoco.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in rows))
    for seed in (0, 1, 3):
        assert pt2i.load_lncoco_captions(str(p), seed=seed) == \
            jt2i.load_lncoco_captions(str(p), seed=seed)
    assert pt2i.load_lncoco_captions(str(p), max_images=2) == \
        jt2i.load_lncoco_captions(str(p), max_images=2)


def _pipelines(jax_seeds, port_seeds):
    def jax_fn(caps, rng):
        jax_seeds.append(_jax_seed(rng))
        return jnp.asarray(_stub_images(jax_seeds[-1], len(caps)))

    def port_fn(caps, seed):
        port_seeds.append(seed)
        return torch.from_numpy(_stub_images(seed, len(caps)))

    return jax_fn, port_fn


def test_sampling_and_selection_match_jax():
    caps = ["a", "b", "c", "d", "e"]
    proto = dict(num_seeds=3, num_inference_steps=1, batch_size=2)
    js, ps = [], []
    jax_fn, port_fn = _pipelines(js, ps)
    want = jt2i.sample_candidates(jax_fn, caps, jt2i.T2IProtocol(**proto), base_seed=5)
    got = pt2i.sample_candidates(port_fn, caps, pt2i.T2IProtocol(**proto), base_seed=5)
    assert ps == js == [5 + s * 100003 + i for s in range(3) for i in (0, 2, 4)]
    assert np.array_equal(got, want)
    assert np.array_equal(pt2i.clip_select(got, caps, _brightness),
                          jt2i.clip_select(want, caps, _brightness))
    best = pt2i.sample_and_select(port_fn, caps, _brightness, pt2i.T2IProtocol(**proto),
                                  base_seed=5)
    assert np.array_equal(best, pt2i.clip_select(got, caps, _brightness))
    assert np.array_equal(best, jt2i.sample_and_select(jax_fn, caps, _brightness,
                                                       jt2i.T2IProtocol(**proto), base_seed=5))


def test_run_protocol_matches_jax(tmp_path):
    jp, pp = inception_params()
    caps = ["one", "two", "three", "four", "five"]
    ref = np.random.default_rng(9).random((6, 16, 16, 3)).astype(np.float32)
    js, ps = [], []
    jax_fn, port_fn = _pipelines(js, ps)
    want = jt2i.run_protocol(jax_fn, _brightness, jp, caps, ref,
                             jt2i.T2IProtocol(num_seeds=3, batch_size=2), shard=False,
                             save_dir=str(tmp_path / "jax"))
    got = pt2i.run_protocol(port_fn, _brightness, pp, caps, ref,
                            pt2i.T2IProtocol(num_seeds=3, batch_size=2), shard=False,
                            save_dir=str(tmp_path / "port"))
    assert ps == js and got["n"] == want["n"] == 5
    assert np.array_equal(np.load(tmp_path / "port" / "images_rank0.npy"),
                          np.load(tmp_path / "jax" / "images_rank0.npy"))
    assert np.isfinite(got["fid"]) and got["fid"] == pytest.approx(want["fid"], rel=FID_REL)


def test_extract_features_pads_the_ragged_tail():
    """5 images at batch 2: the tail is padded to the batch and dropped; the
    features equal those of the images one at a time within float32."""
    _, pp = inception_params()
    x = np.random.default_rng(10).random((5, 16, 16, 3)).astype(np.float32)
    feats = pt2i.extract_inception_features(pp, x, batch_size=2)
    alone = pt2i.extract_inception_features(pp, x[4:], batch_size=1)
    assert feats.shape == (5, 2048)
    np.testing.assert_allclose(feats[4:], alone, rtol=0, atol=1e-6)


def test_run_protocol_shards_by_rank(monkeypatch):
    """Rank 1 of 2 samples captions 1, 3, ...; the features of both ranks are
    gathered before the FID (here rank 0's stand-in is rank 1's own)."""
    _, pp = inception_params()
    seen = []
    monkeypatch.setattr(pcomm, "get_rank", lambda: 1)
    monkeypatch.setattr(pcomm, "get_world_size", lambda: 2)
    monkeypatch.setattr(pcomm, "all_gather_objects", lambda obj: [obj, obj])
    _mean_term_only(monkeypatch)

    def port_fn(caps, seed):
        seen.extend(caps)
        return torch.from_numpy(_stub_images(seed, len(caps)))

    out = pt2i.run_protocol(port_fn, _brightness, pp, ["c0", "c1", "c2", "c3", "c4"],
                            np.random.default_rng(1).random((4, 16, 16, 3)).astype(np.float32),
                            pt2i.T2IProtocol(num_seeds=1, batch_size=4))
    assert seen == ["c1", "c3"] and out["n"] == 4


def test_comm_single_process():
    assert (pcomm.get_rank(), pcomm.get_world_size(), pcomm.is_main_process()) == (0, 1, True)
    pcomm.synchronize()
    assert pcomm.all_gather_objects({"a": 1}) == [{"a": 1}]


# ---------------------------------------------------------------------------
# The eval CLI
# ---------------------------------------------------------------------------


def _mean_term_only(monkeypatch):
    """For the plumbing tests: FID's mean term in place of the whole
    distance. A 2048x2048 ``sqrtm`` takes about 10 s on a CPU; the two
    parity tests above and below hold the real distance to JAX's."""
    monkeypatch.setattr(pt2i, "frechet_distance",
                        lambda mu1, s1, mu2, s2: float(((mu1 - mu2) ** 2).sum()))


def _latents(seed: int, b: int, side: int, vae_levels: int) -> np.ndarray:
    h = side // 2 ** (vae_levels - 1)
    return np.random.default_rng(seed).standard_normal((b, h, h, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def saved_state(tmp_path_factory):
    """One parameter set of the smoke recipe in both packages' checkpoints."""
    from dreamllm_tpu.config import LazyConfig as JaxLazyConfig
    from dreamllm_tpu.models.dreamllm import init_dreamllm_params
    from dreamllm_tpu.models.sd.head import init_sd_head_params
    from dreamllm_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
    from projects.dreamllm import train as jax_train

    root = tmp_path_factory.mktemp("eval_t2i")
    cfg, head_cfg = jax_train.build_model_cfg(JaxLazyConfig.load(SMOKE))

    @jax.jit
    def make_params(rng):
        p = init_dreamllm_params(rng, cfg)
        p["sd_head"] = init_sd_head_params(jax.random.fold_in(rng, 1), head_cfg)
        return p

    params = make_params(jax.random.PRNGKey(21))
    jax_save_checkpoint(str(root / "jax_ck"), 0, params)
    pconfig = LazyArgumentParser().parse(["--config_file", SMOKE, "device=cpu"])[1]
    pcfg, phead = port_train.build_model_cfg(pconfig)
    like = port_train.init_params(pconfig, pcfg, phead, torch.device("cpu"))
    save_checkpoint(str(root / "port_ck"), 0,
                    from_jax(jax.tree.map(np.asarray, params), like, device="cpu"))
    caps = ["a red square", "a blue circle", "a green cat", "a dog on a hill"]
    with open(root / "caps.json", "w") as f:
        json.dump(caps, f)
    _, pp = inception_params()
    ref = np.random.default_rng(11).random((8, 16, 16, 3)).astype(np.float32)
    feats = pt2i.extract_inception_features(pp, ref, batch_size=8)
    from dreamllm_tpu_torch.eval.fid import save_stats_npz

    save_stats_npz(feats, str(root / "ref.npz"))
    return root


def _eval_argv(root, ck, run, extra=()):
    return ["--config_file", SMOKE, f"+captions_json={root}/caps.json",
            f"+fid_reference={root}/ref.npz", "+num_seeds=2", "+num_inference_steps=2",
            "+fid_image_size=16", "+sample_batch_size=2", f"+checkpoint={root}/{ck}",
            f"run_dir={root}/{run}", *extra]


def _patch_port(monkeypatch, vae_levels=2, sdxl=False):
    """The port's entry with the carried Inception and start latents drawn
    by numpy from each chunk's seed; returns the seeds it saw."""
    _, pp = inception_params()
    seeds = []
    name = "sdxl_head_pipeline" if sdxl else "sd_head_pipeline"
    real = getattr(port_eval, name)

    def pipeline(params, cfg, cond, uncond, generator, **kw):
        seeds.append(generator.initial_seed())
        lat = torch.from_numpy(_latents(seeds[-1], cond.shape[0], kw["height"], vae_levels))
        return real(params, cfg, cond, uncond, generator, latents=lat, **kw)

    monkeypatch.setattr(port_eval, name, pipeline)
    monkeypatch.setattr(port_eval, "init_inception_params", lambda **kw: pp)
    return seeds


def test_eval_cli_matches_jax(saved_state, monkeypatch):
    from projects.dreamllm import eval_t2i as jax_eval

    root = saved_state
    jp, _ = inception_params()
    jax_seeds = []
    real = jax_eval.sd_head_pipeline

    def jax_pipeline(params, cfg, cond, uncond, rng, **kw):
        jax_seeds.append(_jax_seed(rng))
        lat = jnp.asarray(_latents(jax_seeds[-1], cond.shape[0], kw["height"], 2))
        return real(params, cfg, cond, uncond, rng, latents=lat, **kw)

    monkeypatch.setattr(jax_eval, "sd_head_pipeline", jax_pipeline)
    monkeypatch.setattr(jax_eval, "init_inception_params",
                        lambda key: jax.tree.map(jnp.asarray, jp))
    port_seeds = _patch_port(monkeypatch)
    want = jax_eval.main(_eval_argv(root, "jax_ck", "jax_run"))
    got = port_eval.main(_eval_argv(root, "port_ck", "port_run", ["device=cpu"]))
    assert port_seeds == jax_seeds == [0, 2, 100003, 100005]
    run = [d for d in os.listdir(root / "port_run")][0]
    written = json.load(open(root / "port_run" / run / "fid_rank0.json"))
    assert written == got and set(got) == {"fid", "n", "inception"}
    assert got["inception"] == "random" and got["n"] == want["n"] == 4
    jrun = [d for d in os.listdir(root / "jax_run")][0]
    pimgs = np.load(root / "port_run" / run / "images_rank0.npy")
    jimgs = np.load(root / "jax_run" / jrun / "images_rank0.npy")
    assert pimgs.shape == jimgs.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(pimgs, jimgs, rtol=0, atol=IMG_ATOL)
    assert got["fid"] == pytest.approx(want["fid"], rel=FID_REL)


def test_eval_cli_sdxl_runs_in_the_port_and_not_in_jax(saved_state, monkeypatch, tmp_path):
    """Fault (d) of the JAX entry: it builds the SD-2.1 head pipeline
    whatever the recipe's ``head_type``, and the SDXL UNet refuses to run
    without its added conditions. The port picks ``sdxl_head_pipeline``."""
    from projects.dreamllm import eval_t2i as jax_eval

    jp, _ = inception_params()
    root = saved_state
    monkeypatch.setattr(jax_eval, "init_inception_params",
                        lambda key: jax.tree.map(jnp.asarray, jp))
    argv = ["--config_file", SDXL_SMOKE, f"+captions_json={root}/caps.json",
            f"+fid_reference={root}/ref.npz", "+num_seeds=1", "+num_inference_steps=2",
            "+fid_image_size=16", "+sample_batch_size=2", f"+checkpoint={tmp_path}/none"]
    with pytest.raises(AssertionError, match="added_cond"):
        jax_eval.main(argv + [f"run_dir={tmp_path}/jax"])
    seeds = _patch_port(monkeypatch, sdxl=True)
    _mean_term_only(monkeypatch)
    got = port_eval.main(argv + ["device=cpu", f"run_dir={tmp_path}/port"])
    assert seeds == [0, 2] and got["n"] == 4 and np.isfinite(got["fid"])


def test_eval_cli_random_clip_text_reranks(saved_state, monkeypatch):
    """``use_random_clip_text``: a random CLIP text tower over the model's
    own vision tower scores each chunk; the run completes and picks from
    both seeds' images by score."""
    root = saved_state
    _patch_port(monkeypatch)
    _mean_term_only(monkeypatch)
    scores = []
    real = port_eval.make_clip_score_fn

    def spy(*a, **kw):
        fn = real(*a, **kw)

        def score(images, caps):
            scores.append(fn(images, caps))
            return scores[-1]
        return score

    monkeypatch.setattr(port_eval, "make_clip_score_fn", spy)
    got = port_eval.main(_eval_argv(root, "port_ck", "port_clip",
                                    ["device=cpu", "+use_random_clip_text=true"]))
    assert got["n"] == 4 and np.isfinite(got["fid"])
    assert len(scores) == 4 and all(s.shape == (2,) and np.isfinite(s).all() for s in scores)


def test_eval_cli_clip_model_dir_without_tokenizer_raises(saved_state, monkeypatch, tmp_path):
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig

    torch.manual_seed(0)
    cfg = CLIPConfig(text_config=CLIPTextConfig(vocab_size=99, hidden_size=32,
                                                intermediate_size=64, num_hidden_layers=1,
                                                num_attention_heads=4,
                                                max_position_embeddings=16).to_dict(),
                     vision_config=CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                                    num_hidden_layers=1, num_attention_heads=4,
                                                    image_size=16, patch_size=8).to_dict(),
                     projection_dim=8)
    CLIPModel(cfg).save_pretrained(tmp_path / "clip")
    _patch_port(monkeypatch)
    with pytest.raises(RuntimeError, match="no loadable CLIP tokenizer"):
        port_eval.main(_eval_argv(saved_state, "port_ck", "port_noclip",
                                  ["device=cpu", f"+clip_model_dir={tmp_path}/clip"]))
