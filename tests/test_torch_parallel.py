"""Data parallelism in the port (``lip2speech_torch/parallel``), on the CPU.

The contract is the one GSPMD gives the JAX package: a step on W ranks, with
a global batch B split into W equal rows, computes the same step as one
rank on the whole of B. ``tests/test_torch_train_step.py`` and
``tests/test_torch_speaker_train.py`` hold the port's one-rank steps
against JAX's unsharded ones, so these tests tie the port's W-rank steps to
JAX through them.

One launch of two ranks over gloo (``RANKS``, ``file://`` rendezvous; this
file run as a script is the worker, which imports nothing of JAX; torch on
one thread) computes, for the plain step, the adversarial step and the
speaker step, in f64, steps on B=4 split 2 + 2 (``STEPS``: two of the
plain and the speaker step, one of the adversarial step), and rank 0 the same
steps on one rank on the whole batch with the same draws:

- each step from the same state (rank 0 copies the two-rank state before
  the step): the losses, the gradients (the two ranks' shares summed, taken
  where the step hands them to the optimizer, before its flatten) and the
  new BatchNorm statistics (the critic's too) within ``REL`` (1e-9) of
  the tensor's largest entry: only the order of the reductions differs.
  Plus ``FLOOR`` (1e-12) of the largest entry of its kind, for tensors that
  are 0 up to rounding (the gradients of conv biases in front of a
  train-mode BatchNorm, the running means behind one: ~1e-17 of their
  kind's largest, and off by as much);
- the parameters after the steps of each run from the same start
  (rank 1 runs the one-rank steps of its own) within ``PARAM_REL`` (1e-6)
  of the tensor's largest entry, and ``grad_norm`` and the speaker's ``t``
  within it: every optimizer works on f32 vectors (``train/optim.py``,
  ``train/adversarial.py``, ``speaker/train_loop.py``). The ranks sum their
  gradients in f64 here, so the two f32 vectors differ where an f64 sum
  rounds to another f32 (none did in the runs measured). Left out are the
  parameters that moved by rounding noise alone (``_moved``): the
  gradients of conv biases in front of a train-mode BatchNorm and of the
  critic's last bias are 0 up to rounding, and Adam-type updates move
  such an entry by up to the learning rate;
- the two ranks' parameters bit for bit.

The critic runs in f64 like the generator; only its RMSprop state and
update are f32, as the AMSGrad's are. The plain config turns on the masked
loss with rows of unequal lengths and both cotangent clips
(``content_grad_clip``, ``scan_grad_clip``), so a rank's local count or
norm would show. The speaker step uses a small stand-in face net (the
real one costs seconds a step in f64 here), with the real face decoder and
voice encoder.

The same launch runs ``evaluate_net`` on a 6-clip LRW fixture at B=4 (a
2-clip ragged tail), f32, with handed-in Griffin-Lim phases: two ranks
against one, each clip's ESTOI and the mean within 1e-6 (the forward of a
clip in a batch of 2 against one of 4 rounds other in f32: 3.0e-08 on the
mean measured). And the contrastive loss of the
gathered embeddings, which is held here against JAX's
``contrastive_loss`` on the whole batch (1e-6).

Held against the JAX package directly (no model compile): the loader's
index sets for 2 shards with a ragged tail, against
``lip2speech_tpu.data.Loader``; and the data-parallel size rule against
``create_mesh``/``auto_mesh`` on the 8 virtual devices.
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
TIMEOUT_S = 120  # each launch; its processes are killed when it expires
B, T, M, HW = 4, 14, 12, 32
TF = 0.5
SEED = 7
# steps a run: two where the optimizer's state must carry over; the
# adversarial step is the plain one with the critic added, and one step of
# its 12.9M-parameter critic holds the critic's part
STEPS = {"plain": 2, "adversarial": 1, "speaker": 2}
REL, FLOOR, PARAM_REL, NOISE = 1e-9, 1e-12, 1e-6, 1e-9
F32_METRICS = ("grad_norm", "t")  # read off the optimizers' f32 vectors
ESTOI_TOL, CONTRASTIVE_TOL = 1e-6, 1e-6
EVAL_CLIPS, EVAL_B, EVAL_GL = 6, 4, 4
SPEAKER_SAMPLES = 8000
SMALL = dict(ffn_hidden_dim=128, content_vocab_size=33, content_latent_dim=64,
             max_decoder_steps=16, postnet_embedding_dim=64, shufflenet_width=0.5)


@pytest.fixture(scope="module")
def one_thread():
    """torch on one thread, as ``torch_port_common.one_torch_thread`` sets
    it (that module imports JAX, which the workers must not)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")


# ---------------------------------------------------------------- the worker

def _configs():
    from lip2speech_torch.config import Config, ModelConfig, TrainConfig

    train = TrainConfig(bf16=False, masked_loss=True)
    plain = Config(model=ModelConfig(**SMALL, content_grad_clip=1e-3, scan_grad_clip=1e-3),
                   train=train)
    return plain, Config(model=ModelConfig(**SMALL), train=TrainConfig(bf16=False))


def _step_batch() -> dict:
    rng = np.random.RandomState(4)
    gate = np.zeros((B, M))
    lengths = np.array([M, M - 3, M, M - 5])
    mask = np.arange(M)[None, :] < lengths[:, None]
    gate[np.arange(B), lengths - 1] = 1.0
    return {"video": torch.from_numpy(rng.randn(B, T, HW, HW, 3) * 0.1),
            "speaker_embedding": torch.from_numpy(rng.randn(B, 256) * 0.1),
            "mel": torch.from_numpy(rng.randn(B, 80, M) - 5.0),
            "gate": torch.from_numpy(gate), "mel_mask": torch.from_numpy(mask)}


def _rows(batch: dict, dp) -> dict:
    from lip2speech_torch.parallel.dist import local_rows

    return {k: local_rows(v, dp.rank, dp.world) for k, v in batch.items()}


class Recorder:
    """Stands in for a step's function (module ``mod``, name ``name``) and
    keeps (losses, new statistics, gradients) of each call; under ``dp`` the
    gradients are summed over the ranks first (the shares' sum)."""

    def __init__(self, mod, name: str, dp):
        self.mod, self.name, self.dp, self.calls = mod, name, dp, []
        self.real = getattr(mod, name)

    def __enter__(self):
        setattr(self.mod, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)

    def keep(self, losses, new_stats, names, grads):
        import torch.distributed as dist

        grads = [g.detach() for g in grads]
        flat = torch.cat([g.reshape(-1) for g in grads])  # a copy: one collective
        if self.dp is not None:
            dist.all_reduce(flat)
        summed = {name: part.view_as(g) for name, g, part in
                  zip(names, grads, flat.split([g.numel() for g in grads]))}
        self.calls.append({"losses": {k: v.clone() for k, v in losses.items()},
                           "stats": {k: v.clone() for k, v in new_stats.items()},
                           "grads": summed})


class UpdateRecorder(Recorder):
    """``apply_update(state, cfg, losses, new_stats, grads, dp=None)``."""

    def __init__(self, mod, name: str, dp, prefix: str = ""):
        super().__init__(mod, name, dp)
        self.prefix = prefix

    def __call__(self, state, cfg, losses, new_stats, grads, dp=None):
        self.keep(losses, new_stats, [self.prefix + n for n in state.opt.names], grads)
        return self.real(state, cfg, losses, new_stats, grads, dp)


class SpeakerRecorder(Recorder):
    """``speaker_loss_and_grad(model, batch, draws, dp=None)``."""

    def __call__(self, model, batch, draws, dp=None):
        out = self.real(model, batch, draws, dp)
        losses, new_stats, grads = out
        names = [f"{group}.{n}" for group in ("face", "decoder")
                 for n, _ in getattr(model, group).named_parameters()] + ["t"]
        self.keep(losses, new_stats, names,
                  [g for group in ("face", "decoder", "t") for g in grads[group]])
        return out


def _params(state) -> dict:
    sd = state.state_dict() if hasattr(state, "state_dict") else state.model.state_dict()
    return {k: v.detach().clone() for k, v in sd.items()}


def _far(got: dict, want: dict, rel: float) -> list:
    """Keys whose tensor in ``got`` is off ``want``'s by more than ``rel``
    of its largest entry plus ``FLOOR`` of the largest entry of its kind
    (a key's last dotted part)."""
    def kind(k):
        return k.rsplit(".", 1)[-1]

    peak = {}
    for k, v in want.items():
        peak[kind(k)] = max(peak.get(kind(k), 0.0), float(v.double().abs().max()))
    return [k for k, v in want.items()
            if float((got[k].double() - v.double()).abs().max())
            > rel * float(v.double().abs().max()) + FLOOR * peak[kind(k)]]


def _moved(refs: list, start: dict, final: dict) -> dict:
    """The tensors of ``final`` that the steps moved by more than rounding
    noise. Left out: those whose every gradient is 0 up to rounding (within
    ``FLOOR`` of the largest, as held above), and, for the critic, whose
    gradients are not recorded, those whose change from the start is
    within ``NOISE`` of the largest change of their kind. The optimizers
    normalise a gradient by its running magnitude plus an epsilon, so they
    move such an entry by up to the learning rate on noise alone, and by
    another noise on each side."""
    peaks = [max(float(g.abs().max()) for g in r["grads"].values()) for r in refs]
    rounding = {k for k in refs[0]["grads"] if all(
        float(r["grads"][k].abs().max()) <= FLOOR * p for r, p in zip(refs, peaks))}
    change = {k: float((v.double() - start[k].double()).abs().max()) for k, v in final.items()}
    peak = {}
    for k, c in change.items():
        peak[k.rsplit(".", 1)[-1]] = max(peak.get(k.rsplit(".", 1)[-1], 0.0), c)
    return {k: v for k, v in final.items()
            if k not in rounding and change[k] > NOISE * peak[k.rsplit(".", 1)[-1]]}


def _stats(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def _run_steps(make_state, step, recorder, batch, dp, steps: int) -> dict:
    """``steps`` steps on two ranks (``dp``); before each, rank 0 runs the same
    step on one rank from a copy of the two-rank state, while rank 1 runs
    a one-rank run of its own from the start, whose parameters it sends to
    rank 0 at the end. ``step(state, batch, dp)`` runs one step in place.
    Returns each rank's metrics of each step and whether the ranks hold the
    same parameters; rank 0 also the keys that are off (``_far``), each
    list empty when the steps agree."""
    import torch.distributed as dist

    from lip2speech_torch.parallel.dist import same_on_all_ranks

    state = make_state()
    start = _params(state)
    out = {"metrics": [], "steps": []}
    own = copy.deepcopy(state)
    local = _rows(batch, dp)
    refs = []
    for _ in range(steps):
        if dp.rank == 0:
            ref = copy.deepcopy(state)
            with recorder(None) as rec:
                metrics = step(ref, batch, None)
            refs.append({**rec.calls[0], "metrics": metrics, "kept": _stats(_params(ref))})
        else:
            step(own, batch, None)
        with recorder(dp) as rec:
            metrics = step(state, local, dp)
        out["metrics"].append(metrics)
        if dp.rank == 0:
            got, want = rec.calls[0], refs[-1]
            plain = {k: v for k, v in want["metrics"].items()
                     if k not in F32_METRICS and k != "notfinite_count"}
            f32 = {k: v for k, v in want["metrics"].items() if k in F32_METRICS}
            out["steps"].append({
                "losses": _far(got["losses"], want["losses"], REL),
                "stats": _far(got["stats"], want["stats"], REL) + ([] if want["stats"] else ["none"]),
                "grads": _far(got["grads"], want["grads"], REL),
                "kept_stats": _far(_stats(_params(state)), want["kept"], REL),
                "metrics": _far(metrics, plain, REL) + _far(metrics, f32, PARAM_REL)})
    final, own_final = _params(state), _params(own)
    for k in sorted(own_final):  # rank 1's own run, to rank 0
        dist.broadcast(own_final[k], src=1)
    if dp.rank == 0:
        moved = _moved(refs, start, own_final)
        out["params"] = _far(final, moved, PARAM_REL)
        out["compared"], out["left_out"] = len(moved), len(own_final) - len(moved)
    out["same_on_ranks"] = same_on_all_ranks(final.values(), dp)
    return out


def plain_steps(dp) -> dict:
    from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
    from lip2speech_torch.train import train_step as ts

    cfg, _ = _configs()

    def make_state():
        model = Lip2Speech(cfg.model, face_net=False)
        init_random_(model, torch.Generator().manual_seed(0))
        return ts.create_train_state(cfg, model.double())

    return _run_steps(
        make_state, lambda st, b, d: ts.train_step(st, b, TF, cfg, seed=SEED, dp=d),
        lambda d: UpdateRecorder(ts, "apply_update", d), _step_batch(), dp, STEPS["plain"])


def adversarial_steps(dp) -> dict:
    from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
    from lip2speech_torch.train import adversarial as adv
    from lip2speech_torch.train import train_step as ts

    _, cfg = _configs()

    class Both:  # the generator's state and the critic, stepped together
        def __init__(self):
            model = Lip2Speech(cfg.model, face_net=False)
            init_random_(model, torch.Generator().manual_seed(0))
            self.gen = ts.create_train_state(cfg, model.double())
            self.critic = adv.init_critic(cfg, torch.Generator().manual_seed(17))
            self.critic.disc.double()

        def state_dict(self):
            return {**{f"g.{k}": v for k, v in self.gen.model.state_dict().items()},
                    **{f"d.{k}": v for k, v in self.critic.disc.state_dict().items()}}

    def step(both, b, d):
        return adv.adversarial_train_step(both.gen, both.critic, b, TF, cfg, seed=SEED, dp=d)

    return _run_steps(Both, step, lambda d: UpdateRecorder(adv, "apply_update", d, "g."),
                      _step_batch(), dp, STEPS["adversarial"])


def speaker_steps(dp) -> dict:
    import torch.nn.functional as F

    from lip2speech_torch.models.layers import BatchNorm2d
    from lip2speech_torch.models.lip2speech import init_random_
    from lip2speech_torch.speaker import train_loop as tl

    _, cfg = _configs()

    class StandIn(torch.nn.Module):
        """A small face net: conv, train-mode BatchNorm, ReLU, mean,
        dropout 0.6 (the first 8 entries of the face net's 1792-wide keep
        mask), a dense layer to 256."""

        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 8, 3, stride=4, bias=False)
            self.bn = BatchNorm2d(8, eps=1e-3)
            self.fc = torch.nn.Linear(8, 256)

        def forward(self, x, keep=None):
            x = F.relu(self.bn(self.conv(x))).mean(dim=(2, 3))
            if self.training:
                x = torch.where(keep[:, :8], x / (1.0 - 0.6), 0.0)
            return self.fc(x)

    class Speaker:
        def __init__(self):
            model = tl.SpeakerTraining(cfg, face_net=StandIn())
            init_random_(model, torch.Generator().manual_seed(3))
            self.state = tl.create_speaker_state(model.double(), steps_per_epoch=1)

        def state_dict(self):
            return self.state.model.state_dict()

    rng = np.random.RandomState(12)
    batch = {"speech": torch.from_numpy(rng.randn(B, SPEAKER_SAMPLES) * 0.1),
             "faces_u8": torch.from_numpy(rng.randint(0, 256, (B, 160, 160, 3)).astype(np.uint8))}
    out = _run_steps(Speaker, lambda sp, b, d: tl.speaker_train_step(sp.state, b, seed=SEED, dp=d),
                     lambda d: SpeakerRecorder(tl, "speaker_loss_and_grad", d), batch, dp,
                     STEPS["speaker"])

    # the contrastive loss of the gathered embeddings, for the JAX check
    from lip2speech_torch.parallel.dist import all_gather_rows
    from lip2speech_torch.speaker.losses import contrastive_loss

    emb = torch.from_numpy(np.random.RandomState(5).randn(2, B, 256))
    temp = torch.tensor(7.0, dtype=torch.float64)
    speech, face = (all_gather_rows(_rows({"x": e}, dp)["x"], dp) for e in emb)
    out["contrastive"] = {"speech": emb[0], "face": emb[1], "temperature": float(temp),
                          "got": {k: float(v) for k, v in contrastive_loss(speech, face,
                                                                           temp).items()}}
    return out


class FirstFrame:
    """A generator whose uniform draws are all 0: every face crop is frame 0
    (the loader's threads would otherwise draw crops in any order)."""

    def random(self, n):
        return np.zeros(n)


def eval_scores(dp, root: str) -> dict:
    from lip2speech_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from lip2speech_torch.data import get_dataset
    from lip2speech_torch.eval.evaluate import evaluate_net
    from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_

    cfg = Config(model=ModelConfig(**SMALL), train=TrainConfig(bf16=False),
                 data=DataConfig(max_video_frames=T))
    model = init_random_(Lip2Speech(cfg.model), torch.Generator().manual_seed(1))
    ds = get_dataset("LRW", root, mode="test", cfg=cfg.data, rng=FirstFrame())
    gen = torch.Generator().manual_seed(2)
    n_freqs = cfg.audio.n_fft // 2 + 1
    thetas = [torch.rand(EVAL_B, n_freqs, cfg.data.max_mel_frames, generator=gen) * 6.0 - 3.0
              for _ in range(-(-EVAL_CLIPS // EVAL_B))]
    kw = dict(batch_size=EVAL_B, n_gl_iters=EVAL_GL, seed=SEED, thetas=thetas)
    out = {}
    if dp.rank == 0:
        stats = {}
        out["ref"] = evaluate_net(model, ds, cfg, stats=stats, **kw)
        out["ref_scores"] = stats["scores"]
    stats = {}
    out["dp"] = evaluate_net(model, ds, cfg, stats=stats, dp=dp, **kw)
    out["dp_scores"] = stats["scores"]
    return out


def worker(rank: int, world: int, init: str, out_dir: str, root: str) -> None:
    import torch.distributed as dist

    from lip2speech_torch.parallel.dist import DataParallel

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    dp = DataParallel(rank, world, torch.device("cpu"), "gloo")
    results = {}
    for name, fn in (("plain", plain_steps), ("adversarial", adversarial_steps),
                     ("speaker", speaker_steps)):
        t0 = time.perf_counter()
        results[name] = fn(dp)
        results[name]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results["eval"] = eval_scores(dp, root)
    results["eval"]["seconds"] = time.perf_counter() - t0
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ------------------------------------------------------------------ harness

def launch(argv_of_rank, env_of_rank=None, timeout: float = TIMEOUT_S) -> list[str]:
    """Start one process per rank, wait for all within ``timeout`` seconds,
    and kill every one of them when it expires (the test then fails; it
    never hangs the suite). Returns each rank's output; fails when a rank
    exits non-zero."""
    procs = []
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    for rank, argv in enumerate(argv_of_rank):
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", PYTHONPATH=path,
                   **((env_of_rank or {}).get(rank, {})))
        procs.append(subprocess.Popen(argv, env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a {len(procs)}-rank launch did not finish in {timeout} s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            pytest.fail(f"rank {rank} exited {p.returncode}:\n{out[-4000:]}")
    return outs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from lip2speech_torch.data import make_sample_lrw

    tmp = tmp_path_factory.mktemp("dp")
    root = str(tmp / "lrw")
    make_sample_lrw(root, n_clips=EVAL_CLIPS, n_frames=T)
    init = f"file://{tmp / 'rendezvous'}"
    t0 = time.perf_counter()
    launch([[sys.executable, __file__, str(r), str(RANKS), init, str(tmp), root]
            for r in range(RANKS)])
    wall = time.perf_counter() - t0
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    out[0]["wall_s"] = wall
    return out


# -------------------------------------------------------------------- tests

@pytest.mark.parametrize("kind", ["plain", "adversarial", "speaker"])
def test_step_on_two_ranks_equals_one_rank(results, kind):
    res = results[0][kind]
    assert len(res["steps"]) == STEPS[kind]
    for s, step in enumerate(res["steps"]):
        assert step == {"losses": [], "stats": [], "grads": [], "kept_stats": [],
                        "metrics": []}, s
    assert res["params"] == [] and res["compared"] > res["left_out"]
    assert res["same_on_ranks"] and results[1][kind]["same_on_ranks"]


@pytest.mark.parametrize("kind", ["plain", "adversarial", "speaker"])
def test_ranks_log_the_global_losses(results, kind):
    for mine, theirs in zip(results[0][kind]["metrics"], results[1][kind]["metrics"]):
        assert mine.keys() == theirs.keys()
        for k, v in mine.items():
            assert torch.equal(v, theirs[k]), k


def test_evaluate_on_two_ranks_equals_one_rank(results):
    ev = results[0]["eval"]
    assert len(ev["ref_scores"]) == EVAL_CLIPS
    assert len(ev["dp_scores"]) + len(results[1]["eval"]["dp_scores"]) == EVAL_CLIPS
    assert abs(ev["dp"] - ev["ref"]) <= ESTOI_TOL
    assert ev["dp"] == results[1]["eval"]["dp"]
    # rank 0 holds clips 0-1 and 4, rank 1 clips 2-3 and 5
    ref = ev["ref_scores"]
    np.testing.assert_allclose(ev["dp_scores"], ref[0:2] + ref[4:5], rtol=0, atol=ESTOI_TOL)
    np.testing.assert_allclose(results[1]["eval"]["dp_scores"], ref[2:4] + ref[5:6], rtol=0,
                               atol=ESTOI_TOL)


def test_gathered_contrastive_loss_matches_jax(results):
    import jax
    import jax.numpy as jnp

    from lip2speech_tpu.speaker.losses import contrastive_loss

    c = results[0]["speaker"]["contrastive"]
    assert c["got"] == results[1]["speaker"]["contrastive"]["got"]
    want = jax.jit(contrastive_loss)(jnp.asarray(c["speech"].numpy(), jnp.float32),
                                     jnp.asarray(c["face"].numpy(), jnp.float32),
                                     jnp.float32(c["temperature"]))
    for k, v in c["got"].items():
        np.testing.assert_allclose(v, float(want[k]), rtol=CONTRASTIVE_TOL)


class _Indices:
    """A dataset whose sample is its index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return int(i)


@pytest.mark.parametrize("n", [11, 9, 14])
def test_loader_shards_match_jax(monkeypatch, n):
    """Both loaders yield the same indices to each of 2 shards over two
    shuffled epochs, ragged tails included (11 and 14 clips leave 3 and 2,
    split between the shards; 9 leaves 1, which both skip), and count the
    same batches."""
    from lip2speech_tpu.data import loader as jloader
    from lip2speech_torch.data import loader as tloader

    for mod in (jloader, tloader):
        monkeypatch.setattr(mod, "collate", lambda samples, cfg: {"idx": np.array(samples)})

    def shards(mod):
        out = []
        for index in range(2):
            ld = mod.Loader(_Indices(n), 4, shuffle=True, drop_last=False, num_workers=2,
                            seed=3, shard_index=index, shard_count=2)
            out.append((len(ld), [b["idx"].tolist() for _ in range(2) for b in ld]))
        return out

    assert shards(tloader) == shards(jloader)


@pytest.mark.parametrize("requested", [-1, 1, 2, 4, 8, 16])
def test_data_parallel_size_matches_create_mesh(requested):
    """On the 8 virtual devices as 8 processes: the port accepts a size
    exactly where ``create_mesh`` does, with the same data axis; -1 is
    every process, as ``auto_mesh`` gives for a batch that 8 divides. (A
    batch that 8 does not divide gets a smaller data axis from
    ``auto_mesh``, leaving devices idle; a process cannot idle, so the port
    refuses it.)"""
    from lip2speech_tpu.parallel import auto_mesh, create_mesh
    from lip2speech_torch.parallel.dist import data_parallel_size

    try:
        want = create_mesh(n_data=requested).shape["data"]
    except (ValueError, AssertionError):
        want = None
    try:
        got = data_parallel_size(requested, 8, 64)
    except ValueError:
        got = None
    assert got == want
    if requested == -1:
        assert got == auto_mesh(64).shape["data"]
    with pytest.raises(ValueError):
        data_parallel_size(-1, 8, 12)


def test_local_rows_and_row_draws():
    """``local_rows`` cuts equal shares; a rank's ``RowDraws`` keeps its rows
    of the draw one rank makes on the whole batch, with several draw rows a
    batch row (the content codebook's slots) and on another batch axis."""
    from lip2speech_torch.parallel.dist import RowDraws, local_rows, uniform

    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(local_rows(x, 1, 3), x[2:4])
    with pytest.raises(ValueError):
        local_rows(x, 0, 4)
    whole_gen = torch.Generator().manual_seed(1)
    whole = [uniform((8, 5), whole_gen, "cpu"), uniform((3, 4, 2), whole_gen, "cpu", 1),
             uniform((3,), whole_gen, "cpu", None)]
    for start in (0, 2):
        rows = RowDraws(torch.Generator().manual_seed(1), start, 2, 4)
        got = [uniform((4, 5), rows, "cpu"), uniform((3, 2, 2), rows, "cpu", 1),
               uniform((3,), rows, "cpu", None)]
        assert torch.equal(got[0], whole[0][2 * start: 2 * start + 4])
        assert torch.equal(got[1], whole[1][:, start: start + 2])
        assert torch.equal(got[2], whole[2])


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
