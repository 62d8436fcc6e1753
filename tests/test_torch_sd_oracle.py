"""The PyTorch port's UNet and VAE against the second oracle, the
independent diffusers-keyed re-implementation in
``tests/_torch_sd_reference.py``. Parameters are initialised once by the
JAX package and reach both sides from there: the port through
``bridge.from_jax``, the oracle through ``dreamllm_tpu.convert.hf_sd``'s
diffusers state-dict export, loaded with ``strict=True`` (every key used,
none missing). Tolerances are those of ``tests/test_sd_torch_parity.py``,
which holds the JAX package against the same oracle: rtol 2e-4, atol 2e-5.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import dreamllm_tpu.models.sd.unet as junet
import dreamllm_tpu.models.sd.vae as jvae
import dreamllm_tpu_torch.models.sd.unet as punet
import dreamllm_tpu_torch.models.sd.vae as pvae
from dreamllm_tpu.convert.hf_sd import export_unet_state_dict, export_vae_state_dict
from tests._torch_port_helpers import n, t, to_port
from tests._torch_sd_reference import TorchUNet, TorchVAE

RTOL, ATOL = 2e-4, 2e-5

UNETS = {
    # test_sd_torch_parity.py's tiny_unet_cfg(): SD-2.1's block layout, 2 levels
    "sd21-style": dict(sample_size=8, block_out_channels=(16, 32),
                       down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                       up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                       layers_per_block=2, transformer_layers_per_block=(1, 1),
                       num_attention_heads=(2, 4), cross_attention_dim=24, norm_num_groups=4),
    # its asymmetric variant: three levels, two transformer layers in the middle one
    "asymmetric": dict(sample_size=8, block_out_channels=(16, 32, 32),
                       down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                                         "DownBlock2D"),
                       up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
                       layers_per_block=2, transformer_layers_per_block=(1, 2, 1),
                       num_attention_heads=(2, 4, 4), cross_attention_dim=24, norm_num_groups=4),
}
VAE = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=4, latent_channels=4)


def _oracle(model, state_dict):
    missing, unexpected = model.load_state_dict(
        {k: t(v) for k, v in state_dict.items()}, strict=True)
    assert not missing and not unexpected
    return model.eval()


@pytest.mark.parametrize("name,seed", [("sd21-style", 0), ("asymmetric", 1)])
def test_unet_forward_matches_the_diffusers_oracle(name, seed):
    jcfg, pcfg = junet.UNetConfig(**UNETS[name]), punet.UNetConfig(**UNETS[name])
    jp = junet.init_unet_params(jax.random.PRNGKey(seed), jcfg)
    pp = to_port(jp, punet.init_unet_params(pcfg, device="meta"))
    oracle = _oracle(TorchUNet(jcfg), export_unet_state_dict(jp))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ts = np.array([7, 321], np.int64)
    ctx = rng.standard_normal((2, 5, 24)).astype(np.float32)
    with torch.no_grad():
        want = oracle(t(x).permute(0, 3, 1, 2), t(ts), t(ctx)).permute(0, 2, 3, 1)
        got = punet.unet_forward(pp, pcfg, t(x), t(ts), t(ctx))
    np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)


class TestVAEOracle:
    @pytest.fixture(scope="class")
    def models(self):
        jcfg, pcfg = jvae.VAEConfig(**VAE), pvae.VAEConfig(**VAE)
        jp = jvae.init_vae_params(jax.random.PRNGKey(0), jcfg)
        pp = to_port(jp, pvae.init_vae_params(pcfg, device="meta"))
        return pcfg, pp, _oracle(TorchVAE(jcfg), export_vae_state_dict(jp))

    def test_encode_moments(self, models):
        pcfg, pp, oracle = models
        x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(np.float32)
        with torch.no_grad():
            mean, logvar = pvae.vae_encode(pp, pcfg, t(x))
            moments = oracle.encode_moments(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        want_mean, want_logvar = moments.chunk(2, dim=-1)
        np.testing.assert_allclose(n(mean), n(want_mean), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(n(logvar), n(want_logvar.clamp(-30.0, 20.0)), rtol=RTOL,
                                   atol=ATOL)

    def test_decode(self, models):
        pcfg, pp, oracle = models
        z = np.random.default_rng(1).standard_normal((2, 4, 4, 4)).astype(np.float32)
        with torch.no_grad():
            got = pvae.vae_decode(pp, pcfg, t(z))
            want = oracle.decode(t(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert tuple(got.shape) == (2, 8, 8, 3)
        np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)
