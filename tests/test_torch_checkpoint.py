"""Train-state checkpoints and the trained weights' way to the AR decode
(torch only).

- Resume: a run saved at step 2 and restored into a fresh state takes the
  same third step as the run that was never interrupted, bit for bit (same
  CPU, same draws: ``train_step`` seeds each step's generator by the seed
  and the step).
- Listing skips temporary files left by a save that was cut short, and an
  explicit step that is missing raises ``FileNotFoundError``.
- After a train step, the AR kernel's weight pack is made again and
  ``Decoder._lstm_bias`` returns the new sum: the update is written in
  place into the parameters, which bumps their versions, so an inference
  after training decodes with the trained weights.
"""

import os

import pytest
import torch

from lip2speech_torch.config import Config, TrainConfig
from lip2speech_torch.kernels import ar_decode as ar
from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
from lip2speech_torch.train.checkpoint import (available_steps, prune_checkpoints,
                                               restore_checkpoint, save_checkpoint)
from lip2speech_torch.train.train_step import create_train_state, train_step
from torch_port_common import small_configs
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, T, M = 2, 8, 12


def _setup(seed: int):
    _, tc = small_configs()
    cfg = Config(model=tc, train=TrainConfig(bf16=False, reject_grad_norm_above=1e6))
    model = init_random_(Lip2Speech(tc, face_net=False), torch.Generator().manual_seed(seed))
    return cfg, create_train_state(cfg, model)


def _batch():
    g = torch.Generator().manual_seed(7)
    gate = torch.zeros(B, M)
    gate[:, -1] = 1.0
    return {"video": torch.randn(B, T, 32, 32, 3, generator=g) * 0.1,
            "speaker_embedding": torch.randn(B, 256, generator=g) * 0.1,
            "mel": torch.randn(B, 80, M, generator=g) - 5.0, "gate": gate,
            "mel_mask": torch.ones(B, M, dtype=torch.bool)}


def test_resume_takes_the_same_next_step(tmp_path):
    batch = _batch()
    cfg, whole = _setup(0)
    for _ in range(3):
        want = train_step(whole, batch, 0.5, cfg)

    cfg, first = _setup(0)
    for _ in range(2):
        train_step(first, batch, 0.5, cfg)
    save_checkpoint(str(tmp_path), first.step, first, extra={"best_score": 0.25})
    cfg, fresh = _setup(1)  # other weights: all of them must come from the file
    state, extra = restore_checkpoint(str(tmp_path), fresh)
    assert state is fresh and fresh.step == 2 and extra == {"best_score": 0.25}
    got = train_step(fresh, batch, 0.5, cfg)

    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    ws, gs = whole.model.state_dict(), fresh.model.state_dict()
    for k, v in ws.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(gs[k], v), k
    for k, v in whole.opt.state_dict().items():
        assert v == fresh.opt.state_dict()[k] if k == "names" else torch.equal(v, fresh.opt.state_dict()[k]), k


def test_listing_skips_leftovers_and_a_missing_step_raises(tmp_path):
    cfg, state = _setup(0)
    assert restore_checkpoint(str(tmp_path / "none"), state) is None
    for step in (2, 5, 9):
        state.step = step
        save_checkpoint(str(tmp_path), step, state)
    (tmp_path / "step_11.pt.tmp-123").write_bytes(b"cut short")
    (tmp_path / "notes.txt").write_text("x")
    assert available_steps(str(tmp_path)) == [2, 5, 9]
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), state, step=7)
    payload, extra = restore_checkpoint(str(tmp_path))
    assert payload["step"] == 9 and extra == {}
    assert not any(k.endswith("num_batches_tracked") for k in payload["model"])
    prune_checkpoints(str(tmp_path), keep=2)
    assert available_steps(str(tmp_path)) == [5, 9]
    assert os.path.exists(tmp_path / "step_11.pt.tmp-123")


def test_a_train_step_reaches_the_ar_weight_pack_and_the_lstm_bias():
    cfg, state = _setup(0)
    dec = state.model.decoder
    with torch.no_grad():
        p = dec.ar_params()
        bias = dec._lstm_bias(0)
        first = ar.packed_weights(cfg.model, p, torch.bfloat16, 7)
        assert ar.packed_weights(cfg.model, dec.ar_params(), torch.bfloat16, 7) is first
    packs = ar.packs
    train_step(state, _batch(), 0.5, cfg)
    with torch.no_grad():
        new_bias = dec._lstm_bias(0)
        assert new_bias is not bias
        assert torch.equal(new_bias, dec.decoder_rnn.bias_ih_l0 + dec.decoder_rnn.bias_hh_l0)
        assert not torch.equal(new_bias, bias)
        again = ar.packed_weights(cfg.model, dec.ar_params(), torch.bfloat16, 7)
    assert ar.packs == packs + 1
    assert not torch.equal(again["w"], first["w"])
