"""The AR-decode CUDA kernel against its plain PyTorch version, on a card.

Marked ``cuda``: each test skips without one. This file imports neither JAX
nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_ar_decode_cuda.py

(``tests/conftest.py`` sets JAX up for the rest of the suite). The small
decoder of tests/test_pallas_decoder.py, random weights from a seed.
"""

import pytest
import torch

from lip2speech_torch.config import ModelConfig
from lip2speech_torch.kernels import ar_decode as ar
from lip2speech_torch.models.decoder import Decoder
from lip2speech_torch.models.lip2speech import init_random_

CFG = ModelConfig(ffn_hidden_dim=128, content_vocab_size=33, content_latent_dim=64,
                  max_decoder_steps=16, postnet_embedding_dim=64)
# mels and stop logits, 16 steps: f32 differs in summation order only;
# bf16 may move one rounding of a product input by one bf16 step
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}


def decoder_inputs(B: int, frames: int = 11):
    """A random small decoder on the card, its AR parameters and inputs of
    ``frames`` video frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(B)
    dec = init_random_(Decoder(CFG), gen).to(dev).eval()
    visual = torch.randn(B, frames, CFG.encoder_embedding_dim, generator=gen).to(dev) * 0.3
    face = torch.randn(B, CFG.face_embedding_dim, generator=gen).to(dev) * 0.3
    with torch.no_grad():
        enc = dec.encode(visual, face, generator=torch.Generator(device=dev).manual_seed(0))
        return dec.ar_params(), enc, dec.BOS.reshape(1, -1).expand(B, -1)


# F = 128 leaves many of the card's blocks without columns of some matrix;
# B = 3, 40 and 130 give ragged row chunks and more rows than one chunk
@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 40, 130])
@pytest.mark.parametrize("weight_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(B, weight_dtype):
    p, enc, bos = decoder_inputs(B)
    with torch.no_grad():
        want = ar.ar_decode_reference(CFG, p, enc, bos, CFG.max_decoder_steps, weight_dtype)
        before = ar.launches
        got = ar.ar_decode(CFG, p, enc, bos, CFG.max_decoder_steps, weight_dtype)
        torch.cuda.synchronize()
    assert ar.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) < TOL[weight_dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("weight_dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_the_eval_tick_shape(weight_dtype):
    """The training run's eval tick decodes B=32 clips for the mels' 80
    frames, more steps than max_decoder_steps (the positions extend)."""
    p, enc, bos = decoder_inputs(32)
    with torch.no_grad():
        want = ar.ar_decode_reference(CFG, p, enc, bos, 80, weight_dtype)
        got = ar.ar_decode(CFG, p, enc, bos, 80, weight_dtype)
        torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] == 80 and bool(torch.isfinite(g).all())
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) < TOL[weight_dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("weight_dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_the_two_second_bucket(weight_dtype):
    """WILD's 2-second segments: the eval tick decodes B=32 clips of T=50
    frames for M=126 steps (1 + 32000 // 256), a longer attention row than
    the 29 frames of LRW."""
    p, enc, bos = decoder_inputs(32, frames=50)
    with torch.no_grad():
        want = ar.ar_decode_reference(CFG, p, enc, bos, 126, weight_dtype)
        got = ar.ar_decode(CFG, p, enc, bos, 126, weight_dtype)
        torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] == 126 and bool(torch.isfinite(g).all())
    assert got[2].shape == (126, 32, 50)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) < TOL[weight_dtype]


@pytest.mark.cuda
def test_unchanged_weights_are_packed_once():
    p, enc, bos = decoder_inputs(4)
    with torch.no_grad():
        ar.ar_decode(CFG, p, enc, bos, CFG.max_decoder_steps)
        packs = ar.packs
        ar.ar_decode(CFG, p, enc, bos, CFG.max_decoder_steps)
        torch.cuda.synchronize()
    assert ar.packs == packs
