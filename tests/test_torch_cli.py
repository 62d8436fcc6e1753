"""The port's entry points on the CPU (``device=cpu``), driven by the repo's
own recipes under ``projects/``:

* the train CLI against the JAX package's, both started from one parameter
  set on ``projects/dreamllm/configs/smoke.py``: the logged ``lm_loss``
  agrees step by step;
* the four ``projects/dreamllm/configs/e2e/`` recipes chained through the
  port's train entry with their stage mixing, then inference (t2i and
  interleaved) and the server on the SFT stage's checkpoint (``/generate``
  equal to ``generate_text``'s greedy tokens, ``/logprob`` to
  ``choice_logprobs``): the port's twin of ``tests/test_e2e_recipe.py``;
* the LLaVA, SD, SDXL and sample entries, and DreamLLM-SDXL inference
  without a checkpoint (it writes its image where the JAX entry raises);
* the refusals: no card without ``device=cpu``, the multi-device recipes;
* ``pretrained.llm/clip/sd`` pointing at tiny HF and diffusers dirs: the
  step-0 parameters equal the JAX entry's merged ones bit for bit, and a
  dir of the wrong shape raises ``ValueError`` in both; and one ``python
  -m`` run of the train entry.
"""

from __future__ import annotations

import glob
import json
import math
import os
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dreamllm_tpu_torch.bridge import from_jax
from dreamllm_tpu_torch.config import LazyArgumentParser
from dreamllm_tpu_torch.projects.dreamllm import inference as port_inference
from dreamllm_tpu_torch.projects.dreamllm import serve as port_serve
from dreamllm_tpu_torch.projects.dreamllm import train as port_train
from dreamllm_tpu_torch.projects.dreamllm_sdxl import inference as port_sdxl_inference
from dreamllm_tpu_torch.projects.dreamllm_sdxl import train as port_sdxl_train
from dreamllm_tpu_torch.projects.llava import train as port_llava_train
from dreamllm_tpu_torch.projects.stable_diffusion import sample as port_sample
from dreamllm_tpu_torch.projects.stable_diffusion import train as port_sd_train
from dreamllm_tpu_torch.projects.stable_diffusion import train_sdxl as port_sdxl_sd_train
from dreamllm_tpu_torch.train.checkpoints import latest_checkpoint, load_params, save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "projects")
SMOKE = f"{CFG}/dreamllm/configs/smoke.py"
CPU = "device=cpu"


def _metrics(run_root: str) -> list[dict]:
    rows = [json.loads(ln) for f in sorted(glob.glob(f"{run_root}/*/metrics.jsonl"))
            for ln in open(f)]
    assert rows, f"no metrics.jsonl under {run_root}"
    return rows


def _pngs(directory: str) -> list[np.ndarray]:
    from PIL import Image

    return [np.asarray(Image.open(f))
            for f in sorted(glob.glob(f"{directory}/**/*.png", recursive=True))]


# ---------------------------------------------------------------------------
# The train CLI against JAX's
# ---------------------------------------------------------------------------

# float32 on both sides; the JAX step runs sharded over the test mesh's 8
# virtual devices and sums in other orders, so the losses agree to float32
# reductions over the vocabulary: about 1e-7 relative at every step (steps
# 2 and 3 carry the updates before them), limit 1e-5. The smoke stream's
# second batch holds creation samples only (no LM label): its loss is 0 in
# both, and step 3 still moves on the AdamW moments of step 1.
CLI_STEPS = 3
LOSS_REL = 1e-5


def test_train_cli_loss_matches_jax(tmp_path):
    import jax

    from dreamllm_tpu.config import LazyConfig as JaxLazyConfig
    from dreamllm_tpu.models.dreamllm import init_dreamllm_params
    from dreamllm_tpu.models.sd.head import init_sd_head_params
    from dreamllm_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
    from projects.dreamllm import train as jax_train

    jcfg = JaxLazyConfig.load(SMOKE)
    cfg, head_cfg = jax_train.build_model_cfg(jcfg)

    @jax.jit
    def make_params(rng):
        p = init_dreamllm_params(rng, cfg)
        p["sd_head"] = init_sd_head_params(jax.random.fold_in(rng, 1), head_cfg)
        return p

    params = make_params(jax.random.PRNGKey(11))
    jax_save_checkpoint(str(tmp_path / "jax_init"), 0, params)
    # the same parameters into the port's checkpoint
    pconfig = LazyArgumentParser().parse(["--config_file", SMOKE, CPU])[1]
    pcfg, phead = port_train.build_model_cfg(pconfig)
    like = port_train.init_params(pconfig, pcfg, phead, torch.device("cpu"))
    save_checkpoint(str(tmp_path / "port_init"), 0,
                    from_jax(jax.tree.map(np.asarray, params), like, device="cpu"))

    common = ["model.loss_weight_vm=0.0", "trainer.log_steps=1",
              f"trainer.max_steps={CLI_STEPS}"]
    jax_train.main(["--config_file", SMOKE, *common, f"run_dir={tmp_path}/jax_run",
                    f"trainer.output_dir={tmp_path}/jax_out",
                    f"+pretrained.resume_from={tmp_path}/jax_init"])
    port_train.main(["--config_file", SMOKE, *common, CPU, f"run_dir={tmp_path}/port_run",
                     f"trainer.output_dir={tmp_path}/port_out",
                     f"+pretrained.resume_from={tmp_path}/port_init"])
    want = [r["train/lm_loss"] for r in _metrics(str(tmp_path / "jax_run"))]
    got = [r["train/lm_loss"] for r in _metrics(str(tmp_path / "port_run"))]
    assert len(got) == len(want) == CLI_STEPS
    for step, (g, w) in enumerate(zip(got, want)):
        assert math.isfinite(g) and abs(g - w) <= LOSS_REL * abs(w), (step + 1, g, w)
    assert got[0] != got[-1]  # the steps moved the parameters


# ---------------------------------------------------------------------------
# The e2e recipe chain through the port
# ---------------------------------------------------------------------------

E2E = f"{CFG}/dreamllm/configs/e2e"
STAGES = ("stage1_creation", "stage1_comprehension", "stage2_interleaved", "sft")
STAGE_DIR = {"stage2_interleaved": "stage2"}


@pytest.fixture(scope="module")
def e2e_root(tmp_path_factory):
    """The four stages in order under one ``DREAMLLM_E2E_ROOT``; stage 2
    mixes the two stage-1 checkpoints, SFT resumes from stage 2."""
    root = str(tmp_path_factory.mktemp("e2e"))
    old = os.environ.get("DREAMLLM_E2E_ROOT")
    os.environ["DREAMLLM_E2E_ROOT"] = root  # the recipes read it when loaded
    try:
        for stage in STAGES:
            port_train.main(["--config_file", f"{E2E}/{stage}.py", CPU])
    finally:
        if old is None:
            del os.environ["DREAMLLM_E2E_ROOT"]
        else:
            os.environ["DREAMLLM_E2E_ROOT"] = old
    return root


@pytest.mark.parametrize("stage", STAGES)
def test_e2e_stage_trained_and_saved(e2e_root, stage):
    d = os.path.join(e2e_root, STAGE_DIR.get(stage, stage))
    rows = _metrics(os.path.join(d, "logs"))
    assert len(rows) == 8 and all(math.isfinite(r["train/loss"]) for r in rows)
    if stage == "stage1_creation":
        assert all(r["train/lm_loss"] == 0.0 for r in rows)  # loss_weight_lm=0
    if stage == "stage1_comprehension":
        assert all(r["train/vm_loss"] == 0.0 for r in rows)  # loss_weight_vm=0
    assert latest_checkpoint(d) == os.path.join(d, "checkpoint-000008")
    log = open(glob.glob(f"{d}/logs/*/log_rank0.txt")[0]).read()
    if stage == "stage2_interleaved":
        assert "stage-mixed plugins" in log and "stage1_comprehension" in log
    if stage == "sft":
        assert "loaded params from" in log and "stage2/checkpoint-000008" in log


def test_e2e_frozen_plugins_carried_across_stages(e2e_root):
    """The UNet is frozen in every stage: SFT's equals stage-1 creation's bit
    for bit (stage mixing carried it through stage 2); the dream queries,
    trained in stage 2 and SFT, moved."""
    c = load_params(latest_checkpoint(os.path.join(e2e_root, "stage1_creation")))
    s = load_params(latest_checkpoint(os.path.join(e2e_root, "sft")))
    for a, b in zip(_leaves(c["sd_head"]["unet"]), _leaves(s["sd_head"]["unet"])):
        assert torch.equal(a, b)
    assert not torch.equal(c["dream_embedding"]["queries"], s["dream_embedding"]["queries"])


def _leaves(tree):
    from dreamllm_tpu_torch.train.tree import tree_leaves

    return list(tree_leaves(tree))


def _e2e_argv(e2e_root, tag, *extra):
    """Inference on the SFT stage; one run dir a test (a stamp has 1 s)."""
    return ["--config_file", f"{E2E}/sft.py", CPU, f"+checkpoint={e2e_root}/sft",
            f"run_dir={e2e_root}/{tag}", *extra]


def test_e2e_inference_t2i(e2e_root):
    out = port_inference.main(_e2e_argv(e2e_root, "t2i", "+mode=t2i", "+num_inference_steps=3"))
    imgs = _pngs(out)
    assert len(imgs) == 1 and imgs[0].shape == (16, 16, 3)


def test_e2e_inference_interleaved(e2e_root):
    out = port_inference.main(_e2e_argv(e2e_root, "interleaved", "+mode=interleaved", "+max_new_tokens=24",
                                        "+num_inference_steps=2"))
    doc = open(os.path.join(out, "document.md")).read()
    assert doc.strip() and doc.count("![image](") == len(_pngs(out))


@pytest.fixture(scope="module")
def e2e_server(e2e_root):
    argv = _e2e_argv(e2e_root, "serve", "+port=0", "+slots=2", "+max_len=128", "+prefill_len=64")
    _, config = LazyArgumentParser().parse(argv)
    server = port_serve.build_server(config, device="cpu")
    server.start(background=True)
    yield server, config
    server.stop()


def _post(server, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _sft_llm(e2e_root, config):
    cfg, _ = port_train.build_model_cfg(config)
    return load_params(latest_checkpoint(os.path.join(e2e_root, "sft")))["llm"], cfg


def test_e2e_server_generate_equals_generate_text(e2e_root, e2e_server):
    from dreamllm_tpu_torch.data.tokenization import ToyTokenizer
    from dreamllm_tpu_torch.generation.sampler import SamplingConfig, generate_text

    server, config = e2e_server
    prompt = "a photo of a red bird"
    got = _post(server, "/generate", {"prompt": prompt, "max_new_tokens": 6, "greedy": True})
    llm, cfg = _sft_llm(e2e_root, config)
    tok = ToyTokenizer(vocab_size=cfg.llm.vocab_size)
    ids = [cfg.special_tokens.bos] + tok.encode(prompt)
    out = generate_text(llm, cfg.llm, torch.tensor([ids]), torch.tensor([len(ids)]),
                        SamplingConfig(greedy=True, max_new_tokens=6,
                                       eos_token_id=cfg.special_tokens.eos),
                        cache_dtype=torch.float32, device="cpu")
    want = out["tokens"][0, :int(out["lengths"][0])].tolist()
    assert got["text"] == tok.decode(want).strip() and want


def test_e2e_server_logprob_equals_choice_logprobs(e2e_root, e2e_server):
    from dreamllm_tpu_torch.data.tokenization import ToyTokenizer
    from dreamllm_tpu_torch.eval.nlp import choice_logprobs

    server, config = e2e_server
    body = {"context": "the sky is", "continuations": ["blue", "very green indeed"]}
    got = _post(server, "/logprob", body)["logprobs"]
    llm, cfg = _sft_llm(e2e_root, config)
    want = choice_logprobs(llm, cfg.llm, ToyTokenizer(vocab_size=cfg.llm.vocab_size),
                           body["context"], body["continuations"])
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# The other entries
# ---------------------------------------------------------------------------


def test_llava_train_trains_the_projector_only(tmp_path):
    from dreamllm_tpu_torch.models.llava import init_llava_params

    argv = ["--config_file", f"{CFG}/llava/configs/pretrain_smoke.py", CPU,
            f"run_dir={tmp_path}/run", f"trainer.output_dir={tmp_path}/out"]
    final = port_llava_train.main(argv)
    rows = _metrics(f"{tmp_path}/run")
    assert int(final.step) == 4 and all(math.isfinite(r["train/lm_loss"]) for r in rows)
    _, config = LazyArgumentParser().parse(argv)
    from dreamllm_tpu_torch.config import instantiate
    from dreamllm_tpu_torch.models.dreamllm import DreamLLMConfig

    m = instantiate(config["model"])
    m.pop("frozen")
    init = init_llava_params(DreamLLMConfig(**m), generator=port_train.seeded("cpu", 0),
                             device="cpu")
    for a, b in zip(_leaves(init["llm"]), _leaves(final.params["llm"])):
        assert torch.equal(a, b)  # frozen
    proj0 = _leaves(init["clip_vision_embedding"]["projector"])
    proj1 = _leaves(final.params["clip_vision_embedding"]["projector"])
    assert any(not torch.equal(a, b) for a, b in zip(proj0, proj1))
    assert latest_checkpoint(f"{tmp_path}/out")


def test_sd_train_moves_the_ema(tmp_path):
    final = port_sd_train.main(["--config_file", f"{CFG}/stable_diffusion/configs/smoke.py",
                                CPU, f"run_dir={tmp_path}/run",
                                f"trainer.output_dir={tmp_path}/out"])
    rows = _metrics(f"{tmp_path}/run")
    assert int(final.step) == 4 and all(math.isfinite(r["train/loss"]) for r in rows)
    head_cfg = port_sd_train.SDHeadConfig(**port_sd_train.instantiate(
        LazyArgumentParser().parse(["--config_file", f"{CFG}/stable_diffusion/configs/smoke.py",
                                    CPU])[1]["sd_head"]))
    init = port_sd_train.init_sd_params(head_cfg, port_train.seeded("cpu", 0), "cpu")
    ema, unet = _leaves(final.ema), _leaves(final.params["unet"])
    first = _leaves(init["unet"])
    assert any(not torch.equal(e, a) for e, a in zip(ema, first))   # the EMA moved
    assert any(not torch.equal(e, u) for e, u in zip(ema, unet))    # and lags the UNet
    assert len(_pngs(f"{tmp_path}/run")) == 1                       # the validation sample


def test_train_sdxl_entry(tmp_path):
    final = port_sdxl_sd_train.main(["--config_file",
                                     f"{CFG}/stable_diffusion/configs/smoke_xl.py", CPU,
                                     f"run_dir={tmp_path}/run",
                                     f"trainer.output_dir={tmp_path}/out"])
    assert "global_projector" in final.params and final.ema is None  # use_ema=False
    assert all(math.isfinite(r["train/loss"]) for r in _metrics(f"{tmp_path}/run"))
    assert latest_checkpoint(f"{tmp_path}/out")


def test_dreamllm_sdxl_train_entry(tmp_path):
    final = port_sdxl_train.main(["--config_file", f"{CFG}/dreamllm_sdxl/configs/smoke.py",
                                  CPU, f"run_dir={tmp_path}/run",
                                  f"trainer.output_dir={tmp_path}/out"])
    assert int(final.step) == 3 and "global_projector" in final.params["sd_head"]
    assert all(math.isfinite(r["train/vm_loss"]) for r in _metrics(f"{tmp_path}/run"))


def test_sample_writes_a_png_from_jax_cond(tmp_path):
    """The sample entry's condition is the JAX entry's numpy draw, bit for
    bit (``projects/stable_diffusion/sample.py``: crc32 of the prompt seeds
    ``default_rng``, cast to float32)."""
    import zlib

    import jax.numpy as jnp

    prompt = "a photo of a corgi"
    g = np.random.default_rng(zlib.crc32(prompt.encode()) % 2**31)
    want = np.asarray(jnp.asarray(g.standard_normal((1, 4, 32)), jnp.float32))
    got = port_sample.prompt_cond(prompt, 4, 32)
    assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want.view(np.int32))
    out = port_sample.main(["--config_file", f"{CFG}/stable_diffusion/configs/smoke.py", CPU,
                            f"run_dir={tmp_path}", f"+prompt={prompt}",
                            f"+checkpoint={tmp_path}/none", "num_inference_steps=3"])
    img = _pngs(os.path.dirname(out))
    assert len(img) == 1 and img[0].shape == (16, 16, 3)


def test_dreamllm_sdxl_inference_without_checkpoint(tmp_path):
    """The JAX entry initialises the SD-2.1 head for any recipe and raises
    ``KeyError: 'global_projector'`` on this one (ROADMAP, reference
    faults); the port picks the head's init by ``head_type`` and writes the
    image."""
    from projects.dreamllm_sdxl import inference as jax_sdxl_inference

    argv = ["--config_file", f"{CFG}/dreamllm_sdxl/configs/smoke.py", "+mode=t2i",
            "+num_inference_steps=2", f"+checkpoint={tmp_path}/none"]
    with pytest.raises(KeyError, match="global_projector"):
        jax_sdxl_inference.main(argv + [f"run_dir={tmp_path}/jax"])
    out = port_sdxl_inference.main(argv + [CPU, f"run_dir={tmp_path}/port"])
    imgs = _pngs(out)
    assert len(imgs) == 1 and imgs[0].shape == (16, 16, 3)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

ENTRIES = {
    "dreamllm.train": (port_train.main, SMOKE),
    "dreamllm.inference": (port_inference.main, SMOKE),
    "dreamllm.serve": (port_serve.main, SMOKE),
    "dreamllm_sdxl.train": (port_sdxl_train.main, f"{CFG}/dreamllm_sdxl/configs/smoke.py"),
    "dreamllm_sdxl.inference": (port_sdxl_inference.main,
                                f"{CFG}/dreamllm_sdxl/configs/smoke.py"),
    "llava.train": (port_llava_train.main, f"{CFG}/llava/configs/pretrain_smoke.py"),
    "stable_diffusion.train": (port_sd_train.main, f"{CFG}/stable_diffusion/configs/smoke.py"),
    "stable_diffusion.train_sdxl": (port_sdxl_sd_train.main,
                                    f"{CFG}/stable_diffusion/configs/smoke_xl.py"),
    "stable_diffusion.sample": (port_sample.main, f"{CFG}/stable_diffusion/configs/smoke.py"),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_without_a_card_raises(entry, tmp_path, monkeypatch):
    """``device`` left at "cuda" raises without a card, before a run dir is
    made; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, recipe = ENTRIES[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(["--config_file", recipe, f"run_dir={tmp_path}/run"])
    assert not os.path.exists(tmp_path / "run")


@pytest.mark.parametrize("recipe,extra,match", [
    ("dreamllm/configs/stage2_longcontext.py", [], "#22"),
    ("dreamllm/configs/stage2_pipeline.py", [], "#22"),
    ("dreamllm/configs/smoke.py", ["mesh.fsdp=2"], "#22"),
    ("llava/configs/pretrain_smoke.py", ["mesh.tp=2"], "#22"),
], ids=["longcontext", "pipeline", "mesh", "llava-mesh"])
def test_what_one_card_cannot_run_is_refused(recipe, extra, match, tmp_path):
    fn = port_llava_train.main if recipe.startswith("llava") else port_train.main
    with pytest.raises(NotImplementedError, match=match):
        fn(["--config_file", f"{CFG}/{recipe}", CPU, f"run_dir={tmp_path}/run", *extra])
    assert not os.path.exists(tmp_path / "run")


# ---------------------------------------------------------------------------
# pretrained.llm / .clip / .sd: HF and diffusers dirs converted in place
# ---------------------------------------------------------------------------

# the smoke recipe's shapes in the published layouts; the HF vocabulary is
# short of the recipe's 40000, so the mean-init resize runs
SMOKE_HF_LLAMA = dict(vocab_size=39990, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256)
SMOKE_HF_CLIP = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                     num_attention_heads=2, image_size=16, patch_size=8)
SMOKE_UNET = dict(sample_size=8, block_out_channels=(16, 32),
                  down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                  up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                  layers_per_block=1, transformer_layers_per_block=(1, 1),
                  num_attention_heads=(2, 4), cross_attention_dim=24, norm_num_groups=4)
SMOKE_VAE = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)


@pytest.fixture(scope="module")
def pretrained_dirs(tmp_path_factory):
    from transformers import CLIPVisionConfig, CLIPVisionModel, LlamaConfig, LlamaForCausalLM

    from tests._torch_port_helpers import write_diffusers_dir

    root = tmp_path_factory.mktemp("pretrained")
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(**SMOKE_HF_LLAMA)).save_pretrained(root / "llm")
    LlamaForCausalLM(LlamaConfig(**{**SMOKE_HF_LLAMA, "hidden_size": 32})).save_pretrained(
        root / "llm_narrow")
    CLIPVisionModel(CLIPVisionConfig(**SMOKE_HF_CLIP)).save_pretrained(root / "clip")
    write_diffusers_dir(root / "sd", SMOKE_UNET, SMOKE_VAE, seed=12)
    return root


class _StepZero:
    """A Trainer that trains nothing: ``train()`` returns the state as the
    entry built it, step 0."""

    def __init__(self, tcfg, step, stream, state, **kw):
        self.state = state

    def train(self):
        return self.state


@pytest.mark.parametrize("keys", [("llm", "clip"), ("sd",)], ids=["hf-llm", "hf-sd"])
def test_pretrained_dirs_match_jax(keys, pretrained_dirs, tmp_path, monkeypatch):
    """``pretrained.llm/clip/sd`` on the smoke recipe: the port's step-0
    parameters converted from the dirs equal ``from_jax`` of the JAX entry's
    merged ones, bit for bit (float32; the LLM's vocabulary grown by
    mean-init rows); every other subtree keeps the port's own init."""
    from projects.dreamllm import train as jax_train

    monkeypatch.setattr(jax_train, "Trainer", _StepZero)
    monkeypatch.setattr(port_train, "Trainer", _StepZero)
    common = ["--config_file", SMOKE, *[f"+pretrained.{k}={pretrained_dirs}/{k}" for k in keys]]
    want = jax_train.main(common + [f"run_dir={tmp_path}/jax"])
    got = port_train.main(common + [CPU, f"run_dir={tmp_path}/port"])
    # the converted subtrees; the random rest is drawn differently by design
    subtrees = {"llm": (("llm",),), "clip": (("clip_vision_embedding", "clip"),),
                "sd": (("sd_head", "unet"), ("sd_head", "vae"))}
    for k in keys:
        for path in subtrees[k]:
            g, w = got.params, want.params
            for p in path:
                g, w = g[p], w[p]
            want_port = from_jax(jax.tree.map(np.asarray, w), g, device="cpu")
            got_leaves = dict(_leaves_with_path(g))
            for leaf_path, leaf in _leaves_with_path(want_port):
                other = got_leaves[leaf_path]
                assert leaf.dtype == other.dtype and torch.equal(
                    leaf.reshape(-1).view(torch.uint8), other.reshape(-1).view(torch.uint8)), (
                    path, leaf_path)
    fresh = port_train.init_params(LazyArgumentParser().parse(["--config_file", SMOKE, CPU])[1],
                                   *port_train.build_model_cfg(
                                       LazyArgumentParser().parse(["--config_file", SMOKE,
                                                                   CPU])[1]), torch.device("cpu"))
    # the converted subtrees replaced the random ones, the rest stayed
    replaced = {"llm": got.params["llm"]["layers"][0]["wq"],
                "clip": got.params["clip_vision_embedding"]["clip"]["layers"][0]["wq"],
                "sd": got.params["sd_head"]["unet"]["conv_in"]["w"]}
    init = {"llm": fresh["llm"]["layers"][0]["wq"],
            "clip": fresh["clip_vision_embedding"]["clip"]["layers"][0]["wq"],
            "sd": fresh["sd_head"]["unet"]["conv_in"]["w"]}
    for k in ("llm", "clip", "sd"):
        assert torch.equal(replaced[k], init[k]) == (k not in keys), k


def test_pretrained_dir_of_the_wrong_shape_raises_in_both(pretrained_dirs, tmp_path):
    from projects.dreamllm import train as jax_train

    argv = ["--config_file", SMOKE, f"+pretrained.llm={pretrained_dirs}/llm_narrow"]
    with pytest.raises(ValueError, match="do not match the configured model"):
        jax_train.main(argv + [f"run_dir={tmp_path}/jax"])
    with pytest.raises(ValueError, match="do not match the configured model"):
        port_train.main(argv + [CPU, f"run_dir={tmp_path}/port"])


def _leaves_with_path(tree):
    from dreamllm_tpu_torch.train.tree import tree_leaves_with_path

    return list(tree_leaves_with_path(tree))


def test_train_entry_runs_as_a_module(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "dreamllm_tpu_torch.projects.dreamllm.train", "--config_file",
         "projects/dreamllm/configs/smoke.py", CPU, "trainer.max_steps=2",
         f"run_dir={tmp_path}/run", f"trainer.output_dir={tmp_path}/out"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert len(_metrics(f"{tmp_path}/run")) == 1  # log_steps=2: one window of 2 steps
    assert latest_checkpoint(f"{tmp_path}/out").endswith("checkpoint-000002")
