"""The PyTorch port stands alone: no module of ``dreamllm_tpu_torch`` (its
``train/`` subpackage included) and no line of ``chip_smoke.py`` imports JAX,
optax, orbax or the JAX package; the kernel sources under ``csrc/`` include
no library of finished kernels; and nothing is compiled when the package is
imported."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "dreamllm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "orbax", "dreamllm_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_separates_the_packages():
    assert _forbidden("dreamllm_tpu.ops.attention") and _forbidden("jax.numpy")
    assert _forbidden("optax") and _forbidden("orbax.checkpoint")
    assert not _forbidden("dreamllm_tpu_torch.ops.attention")


def test_walk_covers_the_training_subpackage():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("optim", "optim8bit", "step", "checkpoints", "trainer", "tree"):
        assert f"dreamllm_tpu_torch/train/{mod}.py" in names


def test_walk_covers_the_serving_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("serve/engine", "ops/quant", "ops/quant4", "utils/errors", "generation/sampler"):
        assert f"dreamllm_tpu_torch/{mod}.py" in names


def test_walk_covers_the_chat_and_t2i_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("generation/chat", "generation/stopping", "data/conversation",
                "data/dataset_types", "data/tokenization", "models/projector", "models/sd/head",
                "models/sd/schedulers"):
        assert f"dreamllm_tpu_torch/{mod}.py" in names


def test_walk_covers_the_lora_and_http_serving_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("train/lora", "train/hp_search", "serve/__init__", "serve/batching",
                "serve/server", "eval/nlp", "utils/image", "utils/logging"):
        assert f"dreamllm_tpu_torch/{mod}.py" in names


def test_walk_covers_the_vqa_driver_and_its_metrics():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("eval/vqa", "eval/metrics", "eval/mmbench", "eval/__init__",
                "generation/__init__"):
        assert f"dreamllm_tpu_torch/{mod}.py" in names


def test_walk_covers_the_model_variants():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("models/sd/sdxl", "models/sd/controlnet", "models/clip_text", "models/llava",
                "models/sd/__init__"):
        assert f"dreamllm_tpu_torch/{mod}.py" in names


def test_walk_covers_the_config_data_and_entry_points():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("config/__init__", "config/lazy", "config/arg_parser", "data/__init__",
                "data/mixed", "data/registry", "data/builder", "data/collator", "data/stream",
                "data/webdataset", "data/filters", "data/catalog", "utils/metrics_logger",
                "projects/__init__", "projects/dreamllm/train", "projects/dreamllm/inference",
                "projects/dreamllm/serve", "projects/dreamllm_sdxl/train",
                "projects/dreamllm_sdxl/inference", "projects/llava/train",
                "projects/stable_diffusion/train", "projects/stable_diffusion/train_sdxl",
                "projects/stable_diffusion/sample"):
        assert f"dreamllm_tpu_torch/{mod}.py" in names


CSRC = sorted((ROOT / "dreamllm_tpu_torch" / "csrc").glob("*"))


@pytest.mark.parametrize("path", CSRC, ids=lambda p: p.name)
def test_kernel_sources_are_hand_written_cuda(path):
    """Every file under ``csrc/`` is a CUDA source that includes only the
    CUDA runtime, the low-level CUDA API's declarations (``cuda.h``: the tensor-map
    types TMA needs), standard headers and the shared headers beside it: no
    cuBLAS, cuDNN, CUTLASS or PyTorch header, and no word of JAX. A source
    defines its kernels and a C interface; a shared header defines neither."""
    assert path.suffix in (".cu", ".cuh"), path.name
    text = path.read_text()
    includes = [ln.split()[1].strip('<>"') for ln in text.splitlines()
                if ln.startswith("#include")]
    allowed = {"cuda.h", "cuda_runtime.h", "cuda_bf16.h", "stdint.h", "type_traits"}
    allowed |= {p.name for p in CSRC if p.suffix == ".cuh"}
    assert set(includes) <= allowed, set(includes) - allowed
    lowered = text.lower()
    for word in ("cublas", "cudnn", "cutlass", "torch/", "import jax", "optax", "orbax"):
        assert word not in lowered, word
    if path.suffix == ".cu":
        assert '__global__' in text and 'extern "C"' in text
    else:
        assert '__global__' not in text and 'extern "C"' not in text


def test_every_kernel_source_is_listed():
    assert [p.name for p in CSRC] == [
        "adam8bit.cu", "flash_bwd.cu", "flash_fwd.cu", "sm90.cuh", "w4a16.cu"]


def test_package_import_loads_no_jax_and_builds_nothing():
    """Import the port with JAX and the JAX package made unimportable (and
    dropped from ``sys.modules``, in case the interpreter preloaded them)."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'optax', 'orbax', 'dreamllm_tpu'):\n"
        "            raise ImportError('the port imported ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'orbax', 'dreamllm_tpu')]:\n"
        "    del sys.modules[m]\n"
        "import dreamllm_tpu_torch.generation.interleaved, dreamllm_tpu_torch.configs\n"
        "import dreamllm_tpu_torch.bridge, dreamllm_tpu_torch.train.trainer\n"
        "import dreamllm_tpu_torch.train.optim, dreamllm_tpu_torch.train.checkpoints\n"
        "import dreamllm_tpu_torch.serve.engine, dreamllm_tpu_torch.ops.quant\n"
        "import dreamllm_tpu_torch.generation.chat, dreamllm_tpu_torch.data.tokenization\n"
        "import dreamllm_tpu_torch.train.lora, dreamllm_tpu_torch.train.hp_search\n"
        "import dreamllm_tpu_torch.serve, dreamllm_tpu_torch.serve.batching\n"
        "import dreamllm_tpu_torch.eval.nlp, dreamllm_tpu_torch.utils.image\n"
        "import dreamllm_tpu_torch.eval.vqa, dreamllm_tpu_torch.eval.metrics\n"
        "import dreamllm_tpu_torch.eval.mmbench, dreamllm_tpu_torch\n"
        "import dreamllm_tpu_torch.models.sd.sdxl, dreamllm_tpu_torch.models.sd.controlnet\n"
        "import dreamllm_tpu_torch.models.clip_text, dreamllm_tpu_torch.models.llava\n"
        "from dreamllm_tpu_torch import beam_search, generate_text_speculative\n"
        "from dreamllm_tpu_torch import sdxl_head_pipeline, controlnet_pipeline, llava_forward\n"
        "import dreamllm_tpu_torch.config, dreamllm_tpu_torch.data.catalog\n"
        "import dreamllm_tpu_torch.utils.metrics_logger\n"
        "import dreamllm_tpu_torch.projects.dreamllm.serve, dreamllm_tpu_torch.projects.llava.train\n"
        "import dreamllm_tpu_torch.projects.dreamllm.inference\n"
        "import dreamllm_tpu_torch.projects.dreamllm_sdxl.train\n"
        "import dreamllm_tpu_torch.projects.dreamllm_sdxl.inference\n"
        "import dreamllm_tpu_torch.projects.stable_diffusion.train_sdxl\n"
        "import dreamllm_tpu_torch.projects.stable_diffusion.sample\n"
        "from dreamllm_tpu_torch.ops import _build\n"
        "assert not _build._loaded\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


def test_walk_covers_the_converters_and_t2i_evaluation():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("convert/cli", "convert/hf_llama", "convert/hf_clip", "convert/hf_sd",
                "convert/inception", "convert/dreamllm_checkpoint", "eval/fid",
                "eval/text2img", "utils/comm", "data/prefetch", "data/native_loader",
                "projects/dreamllm/eval_t2i"):
        assert f"dreamllm_tpu_torch/{mod}.py" in names
