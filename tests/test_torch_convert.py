"""The port's checkpoint converters (``dreamllm_tpu_torch/convert``) against
the JAX package's on the same state dicts, bit for bit: each port tree
equals ``bridge.from_jax`` of JAX's conversion, at float32 and bf16
targets. Nothing is downloaded: LLaMA and CLIP state dicts come from tiny
random ``transformers`` models built here; SD, ControlNet and Inception
state dicts from JAX's ``export_*`` on random JAX trees.

Also: the exporters invert the converters; ``assemble`` writes the port's
checkpoint with JAX's content (and with ``--quantize``, JAX's compiled
quantization: the JAX CLI's eager quantization differs by an ulp in some
scales, counted here); the port reads bf16 ``.safetensors``, which JAX's
reader refuses (pinned, so that a later fix of JAX shows).
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.convert.cli as jcli
import dreamllm_tpu.convert.dreamllm_checkpoint as jref
import dreamllm_tpu.convert.hf_clip as jclipc
import dreamllm_tpu.convert.hf_llama as jllamac
import dreamllm_tpu.convert.hf_sd as jsdc
import dreamllm_tpu.convert.inception as jincc
import dreamllm_tpu_torch.convert.cli as pcli
import dreamllm_tpu_torch.convert.dreamllm_checkpoint as pref
import dreamllm_tpu_torch.convert.hf_clip as pclipc
import dreamllm_tpu_torch.convert.hf_llama as pllamac
import dreamllm_tpu_torch.convert.hf_sd as psdc
import dreamllm_tpu_torch.convert.inception as pincc
import dreamllm_tpu_torch.models.clip as pclip
import dreamllm_tpu_torch.models.clip_text as pct
import dreamllm_tpu_torch.models.llama as pllama
import dreamllm_tpu_torch.models.sd.unet as punet
import dreamllm_tpu_torch.models.sd.vae as pvae
from dreamllm_tpu_torch.bridge import from_jax
from tests._torch_port_helpers import (
    VAE,
    assert_trees_bit_equal,
    config_fields,
    inception_params,
    jax_init,
    np_tree,
    same_bits,
    save_safetensors_dir,
    write_diffusers_dir,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

HF_LLAMA = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
# every projection's K a multiple of 256: int4-able
HF_LLAMA_Q = dict(vocab_size=64, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64)
HF_CLIP = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=4, image_size=28, patch_size=7)
# tiny SD-2.1- and SDXL-layout UNets and a ControlNet over the first
UNET_T = dict(sample_size=8, block_out_channels=(8, 16),
              down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
              up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
              layers_per_block=1, transformer_layers_per_block=(1, 1),
              num_attention_heads=(1, 2), cross_attention_dim=8, norm_num_groups=4)
SDXL_T = dict(sample_size=8, block_out_channels=(8, 16),
              down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
              up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
              layers_per_block=1, transformer_layers_per_block=(1, 2),
              num_attention_heads=(1, 2), cross_attention_dim=8, norm_num_groups=4,
              addition_embed_type="text_time", addition_time_embed_dim=4,
              projection_class_embeddings_input_dim=8 + 6 * 4)
CONTROLNET_T = dict(conditioning_embedding_out_channels=(4, 8))


@functools.lru_cache(maxsize=None)
def hf_llama(kind="base"):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig(**(HF_LLAMA if kind == "base" else HF_LLAMA_Q))).eval()


@functools.lru_cache(maxsize=None)
def hf_clip_vision():
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(1)
    return CLIPVisionModel(CLIPVisionConfig(**HF_CLIP)).eval()


def _llama_like(pcfg):
    return pllama.init_llama_params(pcfg, device="meta")


# ---------------------------------------------------------------------------
# LLaMA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_llama_state_dict_bit_for_bit(dtype):
    jd, pd = DTYPES[dtype]
    hf = hf_llama()
    jcfg = jllamac.llama_config_from_hf(hf.config, dtype=jd)
    pcfg = pllamac.llama_config_from_hf(hf.config, dtype=pd)
    assert config_fields(pcfg) == config_fields(jcfg) and pcfg.dtype == pd
    sd = hf.state_dict()
    want = from_jax(np_tree(jllamac.convert_llama_state_dict(sd, jcfg)), _llama_like(pcfg),
                    device="cpu")
    consumed = dict(sd)
    got = pllamac.convert_llama_state_dict(consumed, pcfg, consume=True)
    assert_trees_bit_equal(from_jax(got, _llama_like(pcfg), device="cpu"), want)
    assert "model.embed_tokens.weight" not in consumed and "lm_head.weight" not in consumed
    # the non-consuming call leaves the source as it was and gives the same tree
    again = pllamac.convert_llama_state_dict(sd, pcfg)
    assert "model.embed_tokens.weight" in sd
    assert_trees_bit_equal(from_jax(again, _llama_like(pcfg), device="cpu"), want)


@pytest.mark.parametrize("src,dst", [("float32", "float32"), ("float32", "bfloat16"),
                                     ("bfloat16", "bfloat16")],
                         ids=["f32-to-f32", "f32-to-bf16", "bf16-to-bf16"])
def test_vocab_resize_bit_for_bit(src, dst):
    """The new rows are the float32 mean of the rows as the tree holds them:
    JAX rounds to the model dtype first, then averages with numpy. A float32
    source into a bf16 target is where averaging the unrounded rows would
    differ."""
    jd, pd = DTYPES[dst]
    hf = hf_llama()
    sd = {k: v.to(DTYPES[src][1]) for k, v in hf.state_dict().items()}
    new_vocab = HF_LLAMA["vocab_size"] + 9
    jcfg = jllamac.llama_config_from_hf(hf.config, dtype=jd)
    pcfg = pllamac.llama_config_from_hf(hf.config, dtype=pd)
    jsd = {k: v.float() for k, v in sd.items()}  # JAX's numpy path reads float32
    jp, jcfg2 = jllamac.resize_vocab_with_mean_init(
        jllamac.convert_llama_state_dict(jsd, jcfg), jcfg, new_vocab)
    pp, pcfg2 = pllamac.resize_vocab_with_mean_init(
        pllamac.convert_llama_state_dict(sd, pcfg), pcfg, new_vocab)
    assert pcfg2.vocab_size == jcfg2.vocab_size == new_vocab
    like = _llama_like(pcfg2)
    got = from_jax(pp, like, device="cpu")
    assert_trees_bit_equal(got, from_jax(np_tree(jp), like, device="cpu"))
    emb = got["embed_tokens"]
    assert torch.equal(emb[-1], emb[-9]) and emb.shape[0] == new_vocab
    if (src, dst) == ("float32", "bfloat16"):
        naive = sd["model.embed_tokens.weight"].float().numpy().mean(axis=0)
        assert not torch.equal(torch.from_numpy(naive).to(torch.bfloat16), emb[-1])
    with pytest.raises(ValueError, match="cannot shrink"):
        pllamac.resize_vocab_with_mean_init(pp, pcfg2, new_vocab - 20)


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_clip_vision_state_dict_bit_for_bit(dtype):
    jd, pd = DTYPES[dtype]
    hf = hf_clip_vision()
    jcfg = jclipc.clip_config_from_hf(hf.config, dtype=jd)
    pcfg = pclipc.clip_config_from_hf(hf.config, dtype=pd)
    assert config_fields(pcfg) == config_fields(jcfg)
    sd = hf.state_dict()
    like = pclip.init_clip_vision_params(pcfg, device="meta")
    want = from_jax(np_tree(jclipc.convert_clip_vision_state_dict(sd, jcfg)), like, device="cpu")
    got = from_jax(pclipc.convert_clip_vision_state_dict(sd, pcfg), like, device="cpu")
    assert_trees_bit_equal(got, want)


def _clip_model_dir(path, with_tokenizer=False) -> str:
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig

    torch.manual_seed(2)
    cfg = CLIPConfig(
        text_config=CLIPTextConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   max_position_embeddings=16, eos_token_id=98).to_dict(),
        vision_config=CLIPVisionConfig(**HF_CLIP).to_dict(),
        projection_dim=24,
    )
    CLIPModel(cfg).eval().save_pretrained(path)
    return str(path)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["default", "bf16"])
def test_clip_model_dir_bit_for_bit(tmp_path, dtype):
    d = _clip_model_dir(tmp_path / "clip")
    j = jclipc.convert_clip_model_dir(d, dtype=DTYPES[dtype][0] if dtype else None)
    p = pclipc.convert_clip_model_dir(d, dtype=DTYPES[dtype][1] if dtype else None)
    (jv, jvt), (jt, jtt), jvp, jtp, jls = j
    (pv, pvt), (pt, ptt), pvp, ptp, pls = p
    assert config_fields(pv) == config_fields(jv) and config_fields(pt) == config_fields(jt)
    vl = pclip.init_clip_vision_params(pv, device="meta")
    tl = pct.init_clip_text_params(pt, device="meta")
    assert_trees_bit_equal(from_jax(pvt, vl, device="cpu"),
                           from_jax(np_tree(jvt), vl, device="cpu"))
    assert_trees_bit_equal(from_jax(ptt, tl, device="cpu"),
                           from_jax(np_tree(jtt), tl, device="cpu"))
    for got, want in ((pvp, jvp), (ptp, jtp), (pls, jls)):
        want = np.asarray(want)
        wt = torch.from_numpy(np.array(want.view(np.int16))).view(torch.bfloat16) \
            if want.dtype.name == "bfloat16" else torch.from_numpy(np.array(want))
        assert same_bits(got, wt)


# ---------------------------------------------------------------------------
# SD: VAE, UNet (SD-2.1 and SDXL layouts), ControlNet
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def sd_trees():
    """JAX-initialised random trees (numpy): VAE, SD-2.1-layout UNet,
    SDXL-layout UNet, ControlNet over the first UNet."""
    import dreamllm_tpu.models.sd.controlnet as jcn
    import dreamllm_tpu.models.sd.unet as junet
    import dreamllm_tpu.models.sd.vae as jvae

    cn_cfg = jcn.ControlNetConfig(unet=junet.UNetConfig(**UNET_T), **CONTROLNET_T)
    return {
        "vae": jax_init(jvae.init_vae_params, jvae.VAEConfig(**VAE), 3),
        "unet": jax_init(junet.init_unet_params, junet.UNetConfig(**UNET_T), 4),
        "sdxl": jax_init(junet.init_unet_params, junet.UNetConfig(**SDXL_T), 5),
        "controlnet": jax_init(jcn.init_controlnet_params, cn_cfg, 6),
    }


def _sd_case(kind, dtype):
    """(JAX config, port config, JAX converter, port converter, port init,
    JAX exporter, port exporter)."""
    import dreamllm_tpu.models.sd.controlnet as jcn
    import dreamllm_tpu.models.sd.unet as junet
    import dreamllm_tpu.models.sd.vae as jvae
    import dreamllm_tpu_torch.models.sd.controlnet as pcn

    jd, pd = DTYPES[dtype]
    if kind == "vae":
        return (jvae.VAEConfig(**VAE, dtype=jd), pvae.VAEConfig(**VAE, dtype=pd),
                jsdc.convert_vae_state_dict, psdc.convert_vae_state_dict, pvae.init_vae_params,
                jsdc.export_vae_state_dict, psdc.export_vae_state_dict)
    if kind in ("unet", "sdxl"):
        kw = UNET_T if kind == "unet" else SDXL_T
        return (junet.UNetConfig(**kw, dtype=jd), punet.UNetConfig(**kw, dtype=pd),
                jsdc.convert_unet_state_dict, psdc.convert_unet_state_dict,
                punet.init_unet_params, jsdc.export_unet_state_dict,
                psdc.export_unet_state_dict)
    return (jcn.ControlNetConfig(unet=junet.UNetConfig(**UNET_T, dtype=jd), **CONTROLNET_T),
            pcn.ControlNetConfig(unet=punet.UNetConfig(**UNET_T, dtype=pd), **CONTROLNET_T),
            jsdc.convert_controlnet_state_dict, psdc.convert_controlnet_state_dict,
            pcn.init_controlnet_params, jsdc.export_controlnet_state_dict,
            psdc.export_controlnet_state_dict)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["vae", "unet", "sdxl", "controlnet"])
def test_sd_converters_bit_for_bit_and_round_trip(kind, dtype):
    jcfg, pcfg, jconv, pconv, pinit, jexport, pexport = _sd_case(kind, dtype)
    sd = jexport(sd_trees()[kind])  # diffusers names, float32 numpy
    like = pinit(pcfg, device="meta")
    got = from_jax(pconv(sd, pcfg), like, device="cpu")
    assert_trees_bit_equal(got, from_jax(np_tree(jconv(sd, jcfg)), like, device="cpu"))
    back = pexport(got)
    assert set(back) == set(sd)
    for k, v in sd.items():
        want = torch.from_numpy(np.array(v)).to(DTYPES[dtype][1])
        assert same_bits(back[k], want), k


def test_sd_dir_bit_for_bit(tmp_path):
    """``convert_sd_dir`` on a diffusers dir (configs read from
    ``unet/config.json`` and ``vae/config.json``) against JAX's."""
    d, _ = write_diffusers_dir(tmp_path / "sd", UNET_T, VAE, seed=7)
    (jucfg, jvcfg), jtree = jcli.convert_sd_dir(d, dtype=jnp.float32)
    (pucfg, pvcfg), ptree = pcli.convert_sd_dir(d, dtype=torch.float32)
    assert config_fields(pucfg) == config_fields(jucfg)
    assert config_fields(pvcfg) == config_fields(jvcfg)
    for k, cfg, init in (("unet", pucfg, punet.init_unet_params),
                         ("vae", pvcfg, pvae.init_vae_params)):
        like = init(cfg, device="meta")
        assert_trees_bit_equal(from_jax(ptree[k], like, device="cpu"),
                               from_jax(np_tree(jtree[k]), like, device="cpu"))


# ---------------------------------------------------------------------------
# Inception
# ---------------------------------------------------------------------------


def test_inception_bit_for_bit_and_round_trip():
    import dreamllm_tpu_torch.eval.fid as pfid

    jp, pp = inception_params()
    sd = jincc.export_inception_state_dict(jp)
    port_sd = pincc.export_inception_state_dict(pp)
    assert set(port_sd) == set(sd)
    for k, v in sd.items():
        assert same_bits(port_sd[k], torch.from_numpy(np.array(v))), k
    like = pfid.init_inception_params(device="meta")
    got = from_jax(pincc.convert_inception_state_dict(sd), like, device="cpu")
    assert_trees_bit_equal(got, from_jax(np_tree(jincc.convert_inception_state_dict(sd)),
                                         like, device="cpu"))
    # the identity-equivalent BN stats fold back to the scales within float32 rounding
    for k in ("stem1", "mixed_7c"):
        blk = got[k] if "conv" in got[k] else got[k]["pool"]
        want = pp[k] if "conv" in pp[k] else pp[k]["pool"]
        torch.testing.assert_close(blk["bn_scale"], want["bn_scale"], rtol=1e-6, atol=0)
        assert same_bits(blk["conv"]["w"], want["conv"]["w"])


# ---------------------------------------------------------------------------
# Reference run dirs
# ---------------------------------------------------------------------------


def test_reference_run_dir_bit_for_bit(tmp_path):
    """A reference-layout run dir (the LLM by ``save_pretrained``, the
    plugin ``.bin`` files with the reference's key names, as
    ``tests/test_reference_ckpt.py`` builds them) through both converters;
    the port's checkpoint loads back equal."""
    import dreamllm_tpu.models.clip as jclip
    import dreamllm_tpu.models.sd.unet as junet
    import dreamllm_tpu.models.sd.vae as jvae
    from dreamllm_tpu_torch.train.checkpoints import latest_checkpoint, load_params

    run = str(tmp_path / "run")
    hf_llama().save_pretrained(run)
    torch.manual_seed(3)
    clip = hf_clip_vision()
    sd = {f"clip_vision_model.{k}": v for k, v in clip.state_dict().items()}
    sd.update({"projector.projector.weight": torch.randn(64, 32),
               "projector.projector.bias": torch.randn(64)})
    torch.save(sd, os.path.join(run, "clip_vision_embedding.bin"))
    torch.save({"dream_queries": torch.randn(1, 4, 64)}, os.path.join(run, "dream_embedding.bin"))
    trees = sd_trees()
    head = {f"unet.{k}": torch.from_numpy(v) for k, v in
            jsdc.export_unet_state_dict(trees["unet"]).items()}
    head.update({f"vae.{k}": torch.from_numpy(v) for k, v in
                 jsdc.export_vae_state_dict(trees["vae"]).items()})
    head.update({"projector.projector.0.weight": torch.randn(16, 64),
                 "projector.projector.2.weight": torch.randn(8, 16),
                 "projector.projector.2.bias": torch.randn(8)})
    torch.save(head, os.path.join(run, "stable_diffusion_head.bin"))

    jcfgs = dict(clip_cfg=jclip.CLIPVisionConfig(**HF_CLIP),
                 unet_cfg=junet.UNetConfig(**UNET_T), vae_cfg=jvae.VAEConfig(**VAE))
    pcfgs = dict(clip_cfg=pclip.CLIPVisionConfig(**HF_CLIP),
                 unet_cfg=punet.UNetConfig(**UNET_T), vae_cfg=pvae.VAEConfig(**VAE))
    want = jref.convert_reference_run_dir(run, dtype=jnp.float32, **jcfgs)
    got = pref.convert_reference_run_dir(run, dtype=torch.float32, out_dir=str(tmp_path / "out"),
                                         **pcfgs)
    assert set(got) == set(want) == {"llm", "clip_vision_embedding", "dream_embedding", "sd_head"}
    # the port's own tree is the template: structure, shapes and dtypes
    assert_trees_bit_equal(got, from_jax(np_tree(want), got, device="cpu"))
    assert_trees_bit_equal(load_params(latest_checkpoint(str(tmp_path / "out"))), got)
    assert len(got["sd_head"]["projector"]["layers"]) == 2


# ---------------------------------------------------------------------------
# The CLI: safetensors, assemble, quantize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_safetensors_dir_reads_every_float_dtype(tmp_path, dtype):
    """The port reads bf16, fp16 and float32 shards as ``safetensors.torch``
    stores them. JAX's reader (``safetensors.numpy``) knows bfloat16 only
    once ``ml_dtypes`` has registered it with numpy, which importing JAX
    does: in a process without JAX (the card's machine has none) it raises
    (fault (a), pinned in a fresh interpreter); with JAX it gives the same
    values as the port."""
    from safetensors.torch import load_file

    td = getattr(torch, dtype)
    sd = {k: v.to(td) for k, v in hf_llama().state_dict().items()}
    d = save_safetensors_dir(tmp_path / dtype, sd)
    got = pcli.load_state_dict_dir(d)
    want = load_file(os.path.join(d, "model.safetensors"))
    assert set(got) == set(want) == set(sd)
    for k in sd:
        assert same_bits(got[k], want[k]) and same_bits(got[k], sd[k].contiguous()), k
    if dtype == "bfloat16":
        child = ("import sys\n"
                 "assert 'ml_dtypes' not in sys.modules\n"
                 "from safetensors.numpy import load_file\n"
                 "try:\n    load_file(sys.argv[1])\n"
                 "except TypeError as e:\n    print('TypeError:', e)\n")
        out = subprocess.run([sys.executable, "-E", "-c", child,
                              os.path.join(d, "model.safetensors")],
                             capture_output=True, text=True, timeout=120)
        assert "TypeError: data type 'bfloat16' not understood" in out.stdout, (
            out.stdout, out.stderr[-2000:])
    jsd = jcli.load_state_dict_dir(d)
    for k in sd:
        assert np.array_equal(np.asarray(jsd[k], np.float32), sd[k].float().numpy()), k


def test_bin_dir_reads_like_jax(tmp_path):
    """``.bin`` shards keep their dtype in the port (JAX widens them to
    float32; every converter rounds to the target dtype either way)."""
    d = tmp_path / "bin"
    d.mkdir()
    sd = {k: v.to(torch.bfloat16) for k, v in hf_llama().state_dict().items()}
    torch.save(dict(list(sd.items())[:5]), d / "pytorch_model-00001.bin")
    torch.save(dict(list(sd.items())[5:]), d / "pytorch_model-00002.bin")
    got = pcli.load_state_dict_dir(str(d))
    want = jcli.load_state_dict_dir(str(d))
    assert set(got) == set(want) == set(sd)
    for k in sd:
        assert same_bits(got[k], sd[k]) and np.array_equal(want[k], got[k].float().numpy())
    with pytest.raises(FileNotFoundError):
        pcli.load_state_dict_dir(str(tmp_path))


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    llm = str(root / "llm")
    hf_llama().save_pretrained(llm)
    llm_q = str(root / "llm_q")
    hf_llama("q").save_pretrained(llm_q)
    clip = str(root / "clip")
    hf_clip_vision().save_pretrained(clip)
    sd, _ = write_diffusers_dir(root / "sd", UNET_T, VAE, seed=8)
    return {"llm": llm, "llm_q": llm_q, "clip": clip, "sd": sd}


def _jax_loaded(path):
    from dreamllm_tpu.train.checkpoints import load_params as jax_load_params

    return np_tree(jax_load_params(path))


def test_assemble_bit_for_bit(tmp_path, hf_dirs):
    """``assemble`` (bf16, the vocabulary grown by 4 mean-init rows) writes
    the port's checkpoint with the content of JAX's orbax one."""
    from dreamllm_tpu_torch.train.checkpoints import load_params

    kw = dict(llm=hf_dirs["llm"], clip=hf_dirs["clip"], sd=hf_dirs["sd"],
              vocab_size=HF_LLAMA["vocab_size"] + 4)
    want = _jax_loaded(jcli.assemble(str(tmp_path / "jax"), **kw))
    got = load_params(pcli.assemble(str(tmp_path / "port"), **kw))
    assert set(got) == set(want) == {"llm", "clip_vision_embedding", "sd_head"}
    assert got["llm"]["embed_tokens"].dtype == torch.bfloat16
    assert got["llm"]["embed_tokens"].shape[0] == HF_LLAMA["vocab_size"] + 4
    assert_trees_bit_equal(got, from_jax(want, got, device="cpu"))


def _jit_quantized_llm(llm_dir, mode):
    """JAX's converted decoder quantized as JAX quantizes for serving, under
    ``jax.jit`` (JAX's ``_quantize_llm_host`` without the eager call)."""
    from dreamllm_tpu.ops.quant import quantize_int8
    from dreamllm_tpu.ops.quant4 import quantize_int4

    quant = jax.jit(quantize_int4 if mode == "int4" else quantize_int8)
    _, p = jcli.convert_llama_dir(llm_dir)

    def q(w):
        if mode == "int4" and w.shape[-2] % 256:
            return w
        return jax.tree.map(np.asarray, quant(w))

    layers = {k: q(v) if k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down") else v
              for k, v in p["layers"].items()}
    return np_tree({**p, "layers": layers, "lm_head": q(p["lm_head"])})


def _codes(x):
    """int4 codes (both nibbles) or int8 codes of a quantized leaf."""
    if hasattr(x, "packed"):
        p = torch.as_tensor(np.asarray(x.packed)).to(torch.int16)
        return torch.cat([p & 0xF, (p >> 4) & 0xF])
    return torch.as_tensor(np.asarray(x.q)).to(torch.int16)


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_assemble_quantized(tmp_path, hf_dirs, mode, capsys):
    """``--quantize``: every quantized leaf equals ``from_jax`` of JAX's
    compiled quantization of its converted tree, bit for bit. Against the
    JAX CLI's own eager quantization (fault (c): eager JAX divides amax by 7
    or 127, compiled JAX and the port multiply by the float32 reciprocal)
    every scale lies within 1 ulp and every code within 1; the counts are
    printed."""
    from dreamllm_tpu_torch.ops.quant import QTensor
    from dreamllm_tpu_torch.ops.quant4 import Q4Tensor
    from dreamllm_tpu_torch.train.checkpoints import load_params

    got = load_params(pcli.assemble(str(tmp_path / "port"), llm=hf_dirs["llm_q"], clip=None,
                                    sd=None, quantize=mode))["llm"]
    kind = Q4Tensor if mode == "int4" else QTensor
    assert isinstance(got["lm_head"], kind) and isinstance(got["layers"][1]["w_down"], kind)
    assert_trees_bit_equal(got, from_jax(_jit_quantized_llm(hf_dirs["llm_q"], mode), got,
                                         device="cpu"))

    eager = from_jax(_jax_loaded(jcli.assemble(str(tmp_path / "jax"), llm=hf_dirs["llm_q"],
                                               clip=None, sd=None, quantize=mode))["llm"],
                     got, device="cpu")
    n_scales = scale_ulps = n_codes = code_moves = 0
    for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"):
        pairs = [(got["lm_head"], eager["lm_head"])] if key == "lm_head" else \
            [(lg[key], le[key]) for lg, le in zip(got["layers"], eager["layers"])]
        for g, e in pairs:
            gs, es = g.scale.view(torch.int32), e.scale.view(torch.int32)
            ulps = (gs.long() - es.long()).abs()
            assert int(ulps.max()) <= 1, key
            dc = (_codes(g) - _codes(e)).abs()
            assert int(dc.max()) <= 1, key
            n_scales += ulps.numel()
            scale_ulps += int((ulps > 0).sum())
            n_codes += dc.numel()
            code_moves += int((dc > 0).sum())
    print(f"[{mode}] eager JAX vs port: {scale_ulps}/{n_scales} scales 1 ulp apart, "
          f"{code_moves}/{n_codes} codes 1 apart")
    assert scale_ulps > 0  # the fault shows at these sizes


def test_quantize_skips_k_not_multiple_of_256(monkeypatch):
    """Decoder projections whose K is not a multiple of 256 stay unquantized
    in int4, with one warning each (JAX's skip); int8 takes every K."""
    from dreamllm_tpu_torch.ops.quant import QTensor

    hf = hf_llama()  # hidden 64, intermediate 128
    pcfg = pllamac.llama_config_from_hf(hf.config, dtype=torch.float32)
    p = from_jax(pllamac.convert_llama_state_dict(hf.state_dict(), pcfg), _llama_like(pcfg),
                 device="cpu")
    warnings = []
    monkeypatch.setattr(pcli.logger, "warning", lambda msg, *a: warnings.append(msg % a))
    q4 = pcli._quantize_llm_host(p, "int4")
    assert torch.equal(q4["layers"][0]["wq"], p["layers"][0]["wq"])
    assert len(warnings) == 8 and all("skipping int4" in w for w in warnings)  # 7 keys + head
    q8 = pcli._quantize_llm_host(p, "int8")
    assert isinstance(q8["layers"][1]["w_up"], QTensor) and isinstance(q8["lm_head"], QTensor)


def test_cli_runs_as_a_module(tmp_path, hf_dirs):
    out = subprocess.run(
        [sys.executable, "-m", "dreamllm_tpu_torch.convert.cli", "--llm", hf_dirs["llm"],
         "--clip", hf_dirs["clip"], "--out", str(tmp_path / "ck"), "--vocab_size", "100"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    from dreamllm_tpu_torch.train.checkpoints import latest_checkpoint, load_params

    got = load_params(latest_checkpoint(str(tmp_path / "ck")))
    assert got["llm"]["embed_tokens"].shape == (100, 64)
    assert got["llm"]["embed_tokens"].dtype == torch.bfloat16
    assert "clip" in got["clip_vision_embedding"]
