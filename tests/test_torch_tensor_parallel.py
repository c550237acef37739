"""Tensor parallelism in the port (``lip2speech_torch/parallel/tensor.py``),
on the CPU.

The contract is the one GSPMD gives the JAX package: a step on a grid of
``n_data x n_model`` ranks, with the K/V conv banks and ``conv_last``
sharded on their output channels over each model group and the global
batch B split over the data index, computes the same step as one rank on
the whole of B. ``tests/test_torch_train_step.py`` holds the port's
one-rank step against JAX's, so this ties the grid's step to JAX through
it.

One launch of four ranks as a 2 x 2 grid over gloo (``file://``
rendezvous). This file run as a script is the launch: it imports torch and
the port once (nothing of JAX) and forks the four ranks, each on one torch
thread, so the start-up is paid once. In f64, on B=4 split 2 + 2, one plain
step and one adversarial step (the critic's blocks narrowed to
``CRITIC_BLOCKS``), and rank 0 the same steps on one rank on the whole
batch with the same draws:

- the losses, the gradients (summed over the data group and gathered over
  the model group, taken where the step hands them to the optimizer) and
  the new BatchNorm statistics within ``REL`` (1e-9) of the tensor's
  largest entry (plus ``FLOOR`` of its kind's largest, for tensors that are
  0 up to rounding), as ``tests/test_torch_parallel.py`` holds them;
- the gathered parameters after the step within ``PARAM_REL`` (1e-6),
  leaving out those that moved by rounding noise alone (``_moved``);
- every replicated tensor bit for bit the same on the four ranks (so on
  the two ranks of each model group), and each shard on the two ranks of
  its data group;
- the plain config turns on the masked loss with rows of unequal length and
  both cotangent clips, so a count or a norm reduced over the world (which
  counts a model group's rows twice) shows.

The same launch runs ``evaluate_net`` on the grid against one rank (each
clip's ESTOI within 1e-6), and moves checkpoints between the grid and one
rank, bit for bit both ways.

Held against the JAX package directly (no model compile): the sharded names
and dims against ``partition_params`` on ``jax.eval_shape`` of the model
(small and full width, and a model axis of 3, which the banks' 128
channels do not split); a rank's state dict (``weights.rank_from_flax``)
against the addressable shards of ``shard_pytree`` on a 4 x 2 virtual
mesh; the grid's size rule against ``create_mesh``/``auto_mesh``.
"""

from __future__ import annotations

import copy
import importlib
import functools
import os
import sys
import time

import numpy as np
import pytest
import torch

N_DATA, N_MODEL = 2, 2
RANKS = N_DATA * N_MODEL
TIMEOUT_S = 120  # the launch; its processes are killed when it expires
B, T, M, HW = 4, 14, 12, 32
TF = 0.5
SEED = 7
REL, FLOOR, PARAM_REL = 1e-9, 1e-12, 1e-6
ESTOI_TOL = 1e-6
# one clip a data index
EVAL_CLIPS, EVAL_B, EVAL_GL, EVAL_SAMPLES = 2, 2, 4, 4096
# the critic's residual blocks, narrowed from (256 ... 1024) for the CPU
CRITIC_BLOCKS = ((64, True), (64, True), (64, False))
SMALL = dict(ffn_hidden_dim=128, content_vocab_size=33, content_latent_dim=64,
             max_decoder_steps=16, postnet_embedding_dim=64, shufflenet_width=0.5)


@pytest.fixture(scope="module")
def one_thread():
    """torch on one thread (``torch_port_common.one_torch_thread``'s rule)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")


# ---------------------------------------------------------------- the worker

def _configs():
    from lip2speech_torch.config import Config, ModelConfig, TrainConfig

    plain = Config(model=ModelConfig(**SMALL, content_grad_clip=1e-3, scan_grad_clip=1e-3),
                   train=TrainConfig(bf16=False, masked_loss=True))
    return plain, Config(model=ModelConfig(**SMALL), train=TrainConfig(bf16=False))


def _model(cfg, dp=None):
    """The seeded small model in f64, sharded over ``dp``'s model group."""
    from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
    from lip2speech_torch.parallel import tensor

    model = init_random_(Lip2Speech(cfg.model, face_net=False), torch.Generator().manual_seed(0))
    model.double()
    tensor.shard_(model, dp)
    return model


class GridRecorder:
    """Stands in for ``apply_update`` in module ``mod`` and keeps (losses,
    new statistics, gradients) of each call; under ``dp`` the gradients
    are summed over the data group and the shards gathered over the model
    group (the one-rank gradients)."""

    def __init__(self, mod, dp, prefix: str = ""):
        self.mod, self.dp, self.prefix, self.calls = mod, dp, prefix, []
        self.real = mod.apply_update

    def __enter__(self):
        self.mod.apply_update = self
        return self

    def __exit__(self, *exc):
        self.mod.apply_update = self.real

    def __call__(self, state, cfg, losses, new_stats, grads, dp=None):
        from lip2speech_torch.parallel import tensor
        from lip2speech_torch.parallel.dist import all_reduce_

        opt = state.opt
        flat = all_reduce_(opt.flatten([g.detach() for g in grads], dtype=None), self.dp)
        if opt.shard_mask is not None:
            flat = tensor.gather_flat(flat, opt.params, opt.sharded, opt.tp)
        shapes = [(p.shape[0] * (opt.tp.n_model if s else 1), *p.shape[1:])
                  for p, s in zip(opt.params, opt.sharded)]
        parts = flat.split([int(np.prod(s)) for s in shapes])
        self.calls.append({
            "losses": {k: v.clone() for k, v in losses.items()},
            "stats": {k: v.clone() for k, v in new_stats.items()},
            "grads": {self.prefix + n: g.view(s) for n, g, s in zip(opt.names, parts, shapes)}})
        return self.real(state, cfg, losses, new_stats, grads, dp)


def _grid_step(make, step, mod, prefix, batch, dp) -> dict:
    """One step on the grid (``dp``) and, on rank 0, the same step on one
    rank; ``make(dp)`` makes the state (sharded over ``dp``), ``step(state,
    batch, dp)`` runs the step in place and ``full(state)`` (the state's
    ``full`` method) gives its gathered state dict."""
    from test_torch_parallel import _far, _moved, _stats

    from lip2speech_torch.parallel import tensor
    from lip2speech_torch.parallel.dist import local_rows, same_on_all_ranks

    state = make(dp)
    local = {k: local_rows(v, dp.data_index, dp.n_data) for k, v in batch.items()}
    out = {}
    with GridRecorder(mod, dp, prefix) as rec:
        metrics = step(state, local, dp)
    out["metrics"] = metrics
    got, final = rec.calls[0], state.full()
    rep, shards = [], []
    for module in state.modules():
        held, cut = tensor.state_parts(module)
        rep, shards = rep + held, shards + cut
    out["same_on_ranks"] = same_on_all_ranks(rep + list(metrics.values()), dp, shards)
    if dp.rank == 0:
        ref = make(None)
        start = copy.deepcopy(ref.full())
        with GridRecorder(mod, None, prefix) as rec:
            want_metrics = step(ref, batch, None)
        want = rec.calls[0]
        ref_final = ref.full()
        moved = _moved([want], start, ref_final)
        plain = {k: v for k, v in want_metrics.items() if k not in ("grad_norm", "notfinite_count")}
        out.update(
            losses=_far(got["losses"], want["losses"], REL),
            stats=_far(got["stats"], want["stats"], REL) + ([] if want["stats"] else ["none"]),
            grads=_far(got["grads"], want["grads"], REL),
            kept_stats=_far(_stats(final), _stats(ref_final), REL),
            metric_values=_far(metrics, plain, REL) + _far(
                {"grad_norm": metrics["grad_norm"]}, {"grad_norm": want_metrics["grad_norm"]},
                PARAM_REL),
            params=_far({k: final[k] for k in moved}, moved, PARAM_REL),
            compared=len(moved), left_out=len(ref_final) - len(moved))
        out["ref"] = ref
    out["state"] = state
    return out


class Gen:
    """The generator's train state, as the grid's steps hold it."""

    def __init__(self, cfg, dp):
        # the module: the package exports a function of its name
        ts = importlib.import_module("lip2speech_torch.train.train_step")

        self.gen = ts.create_train_state(cfg, _model(cfg, dp))

    def modules(self):
        return [self.gen.model]

    def full(self) -> dict:
        from lip2speech_torch.parallel import tensor

        return {f"g.{k}": v.detach().clone()
                for k, v in tensor.full_state_dict(self.gen.model).items()}


class Both(Gen):
    """The generator's state and the critic, stepped together."""

    def __init__(self, cfg, dp):
        from lip2speech_torch.train import adversarial as adv

        super().__init__(cfg, dp)
        self.critic = adv.init_critic(cfg, torch.Generator().manual_seed(17))
        self.critic.disc.double()

    def modules(self):
        return [self.gen.model, self.critic.disc]

    def full(self) -> dict:
        return {**super().full(), **{f"d.{k}": v.detach().clone()
                                     for k, v in self.critic.disc.state_dict().items()}}


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


def plain_step(dp) -> dict:
    # the module: the package exports a function of its name
    ts = importlib.import_module("lip2speech_torch.train.train_step")

    cfg, _ = _configs()
    return _grid_step(lambda d: Gen(cfg, d),
                      lambda st, b, d: ts.train_step(st.gen, b, TF, cfg, seed=SEED, dp=d),
                      ts, "g.", _step_batch(), dp)


def adversarial_step(dp) -> dict:
    from lip2speech_torch.models import discriminator
    from lip2speech_torch.train import adversarial as adv

    _, cfg = _configs()
    discriminator.BLOCKS = CRITIC_BLOCKS
    return _grid_step(
        lambda d: Both(cfg, d),
        lambda st, b, d: adv.adversarial_train_step(st.gen, st.critic, b, TF, cfg, seed=SEED,
                                                    dp=d),
        adv, "g.", _step_batch(), dp)


class FirstFrame:
    """A generator whose uniform draws are all 0: every face crop is frame 0."""

    def random(self, n):
        return np.zeros(n)


def eval_scores(dp, root: str) -> dict:
    from lip2speech_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from lip2speech_torch.data import get_dataset
    from lip2speech_torch.eval.evaluate import evaluate_net
    from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
    from lip2speech_torch.parallel import tensor

    cfg = Config(model=ModelConfig(**SMALL), train=TrainConfig(bf16=False),
                 data=DataConfig(max_video_frames=T, max_audio_samples=EVAL_SAMPLES,
                                 max_mel_frames=EVAL_SAMPLES // 256 + 1))

    def model(d):
        m = init_random_(Lip2Speech(cfg.model), torch.Generator().manual_seed(1))
        tensor.shard_(m, d)
        return m

    ds = get_dataset("LRW", root, mode="test", cfg=cfg.data, rng=FirstFrame())
    gen = torch.Generator().manual_seed(2)
    n_freqs = cfg.audio.n_fft // 2 + 1
    thetas = [torch.rand(EVAL_B, n_freqs, cfg.data.max_mel_frames, generator=gen) * 6.0 - 3.0
              for _ in range(-(-EVAL_CLIPS // EVAL_B))]
    kw = dict(batch_size=EVAL_B, n_gl_iters=EVAL_GL, seed=SEED, thetas=thetas)
    out = {}
    if dp.rank == 0:
        stats = {}
        out["ref"] = evaluate_net(model(None), ds, cfg, stats=stats, **kw)
        out["ref_scores"] = stats["scores"]
    stats = {}
    out["grid"] = evaluate_net(model(dp), ds, cfg, stats=stats, dp=dp, **kw)
    out["grid_scores"] = stats["scores"]
    return out


def _bitwise(got: dict, want: dict) -> list:
    """The keys of ``want`` whose value ``got`` does not hold bit for bit."""
    def same(a, b):
        return torch.equal(a, b) if torch.is_tensor(b) else a == b

    return sorted(k for k in want if not same(got[k], want[k]))


def checkpoints(dp, state, ref, out_dir: str) -> dict:
    """The plain step's grid ``state`` saved and restored into one rank on
    rank 0; the one-rank state after the same step (``ref``, rank 0's)
    saved on rank 0 and restored into the grid on every rank. Each side bit
    for bit against what was saved."""
    from lip2speech_torch.parallel import tensor
    from lip2speech_torch.parallel.dist import barrier
    from lip2speech_torch.train import checkpoint as ckpt
    # the module: the package exports a function of its name
    ts = importlib.import_module("lip2speech_torch.train.train_step")

    cfg, _ = _configs()
    out = {}
    grid_dir, one_dir = os.path.join(out_dir, "ckpt_grid"), os.path.join(out_dir, "ckpt_one")
    saved_model = tensor.full_state_dict(state.model)
    saved_opt = state.opt.state_dict()
    ckpt.save_checkpoint(grid_dir, state.step, state, {"best_score": 0.5}, dp)
    if dp.rank == 0:
        one = ts.create_train_state(cfg, _model(cfg))
        _, extra = ckpt.restore_checkpoint(grid_dir, one)
        out["grid_to_one"] = (_bitwise(one.model.state_dict(), saved_model)
                              + _bitwise(one.opt.state_dict(), saved_opt)
                              + ([] if one.step == state.step == 1 else ["step"])
                              + ([] if extra == {"best_score": 0.5} else ["extra"]))
        ckpt.save_checkpoint(one_dir, ref.step, ref)
    barrier(dp)
    grid = ts.create_train_state(cfg, _model(cfg, dp))
    ckpt.restore_checkpoint(one_dir, grid)
    payload, _ = ckpt.restore_checkpoint(one_dir)
    _, names = tensor.layout(grid.model)
    want = {k: tensor.shard(v, dp) if k in names else v for k, v in payload["model"].items()}
    opt = payload["optimizer"]
    want_opt = {k: tensor.shard_flat(opt[k], grid.opt.params, grid.opt.sharded, dp)
                for k in grid.opt.MOMENTS}
    got = {k: v for k, v in grid.model.state_dict().items() if k in want}
    out["one_to_grid"] = (_bitwise(got, want)
                          + _bitwise({k: getattr(grid.opt, k) for k in want_opt}, want_opt)
                          + ([] if grid.step == payload["step"] == 1 else ["step"]))
    out["sharded"] = len(names)
    return out


def worker(rank: int, init: str, out_dir: str, root: str) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    from lip2speech_torch.parallel.dist import join_grid

    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=RANKS,
                            timeout=timedelta(seconds=TIMEOUT_S))
    dp = join_grid(rank, RANKS, torch.device("cpu"), "gloo", N_MODEL)
    results, seconds = {}, {}
    for name, fn in (("plain", plain_step), ("adversarial", adversarial_step)):
        t0 = time.perf_counter()
        results[name] = fn(dp)
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = results["plain"]
    results["checkpoints"] = checkpoints(dp, plain["state"].gen,
                                         plain["ref"].gen if rank == 0 else None, out_dir)
    seconds["checkpoints"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results["eval"] = eval_scores(dp, root)
    seconds["eval"] = time.perf_counter() - t0
    for name in ("plain", "adversarial"):
        results[name].pop("state"), results[name].pop("ref", None)
    results["seconds"] = seconds
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def fork_ranks(init: str, out_dir: str, root: str) -> int:
    """Import once, then fork the ranks (rank 0 in this process); each child
    dies with this process. Returns the exit code: non-zero when a rank
    failed."""
    import ctypes
    import signal
    import traceback

    import lip2speech_torch.eval.evaluate  # noqa: F401 (imported before the fork)
    import lip2speech_torch.train.adversarial  # noqa: F401

    torch.set_num_threads(1)
    children = []
    for rank in range(1, RANKS):
        pid = os.fork()
        if pid == 0:
            ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
            code = 0
            try:
                worker(rank, init, out_dir, root)
            except BaseException:
                traceback.print_exc()
                code = 1
            sys.stdout.flush()
            os._exit(code)
        children.append(pid)
    worker(0, init, out_dir, root)
    return int(any(os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1]) for pid in children))


# ------------------------------------------------------------------ harness

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from test_torch_parallel import launch

    from lip2speech_torch.data import make_sample_lrw

    tmp = tmp_path_factory.mktemp("tp")
    root = str(tmp / "lrw")
    make_sample_lrw(root, n_clips=EVAL_CLIPS, n_frames=T, n_samples=EVAL_SAMPLES)
    t0 = time.perf_counter()
    launch([[sys.executable, __file__, f"file://{tmp / 'rendezvous'}", str(tmp), root]],
           timeout=TIMEOUT_S)
    wall = time.perf_counter() - t0
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    out[0]["wall_s"] = wall
    return out


# -------------------------------------------------------------------- tests

@pytest.mark.parametrize("kind", ["plain", "adversarial"])
def test_step_on_a_grid_equals_one_rank(results, kind):
    res = results[0][kind]
    for part in ("losses", "stats", "grads", "kept_stats", "metric_values", "params"):
        assert res[part] == [], (part, res[part])
    assert res["compared"] > res["left_out"]


@pytest.mark.parametrize("kind", ["plain", "adversarial"])
def test_replicated_tensors_and_losses_agree_on_every_rank(results, kind):
    """Every replicated tensor and the logged metrics bit for bit on the four
    ranks; each shard on the two ranks of its data group."""
    assert all(r[kind]["same_on_ranks"] for r in results)
    for r in results[1:]:
        for k, v in results[0][kind]["metrics"].items():
            assert torch.equal(v, r[kind]["metrics"][k]), k


def test_evaluate_on_a_grid_equals_one_rank(results):
    ev = results[0]["eval"]
    assert len(ev["ref_scores"]) == EVAL_CLIPS
    assert abs(ev["grid"] - ev["ref"]) <= ESTOI_TOL
    assert all(r["eval"]["grid"] == ev["grid"] for r in results)
    # data index d (ranks 2d, 2d + 1) holds clip d
    ref = ev["ref_scores"]
    for rank, r in enumerate(results):
        d = rank // N_MODEL
        np.testing.assert_allclose(r["eval"]["grid_scores"], ref[d: d + 1], rtol=0,
                                   atol=ESTOI_TOL)


def test_checkpoint_of_the_grid_restores_into_one_rank(results):
    assert results[0]["checkpoints"]["grid_to_one"] == []


def test_checkpoint_of_one_rank_restores_into_the_grid(results):
    for r in results:
        assert r["checkpoints"]["one_to_grid"] == [] and r["checkpoints"]["sharded"] == 11


@functools.lru_cache(maxsize=4)
def _jax_param_shapes(jc):
    import jax
    import jax.numpy as jnp

    from lip2speech_tpu.models.lip2speech import Lip2Speech as JLip2Speech
    from torch_port_common import to_plain

    video = jnp.zeros((2, T, 48, 48, 3))
    spk = jnp.zeros((2, jc.face_embedding_dim))
    return to_plain(jax.eval_shape(lambda: JLip2Speech(jc).init(
        {"params": jax.random.PRNGKey(0)}, video, None, None, 1.0, spk,
        {"gumbel": jax.random.PRNGKey(1)}, train=False)))


def _torch_names(tc) -> dict:
    """JAX param path -> the port's parameter name (``weights.build_entries``)."""
    from lip2speech_torch import weights

    return {weights._normalize_fpath(fpath): tkey for tkey, fpath, _ in weights.build_entries(tc)
            if fpath[0] == "params"}


@pytest.mark.parametrize("size, n_model", [("small", 2), ("default", 2), ("small", 3)])
def test_sharded_names_match_partition_params(size, n_model):
    """The port shards the tensors and dims JAX's ``partition_params`` shards
    (the output channels: JAX's last dim, the port's dim 0); at a model
    axis of 3 the banks' 128 channels stay whole and ``conv_last``'s 768
    shard."""
    import jax
    from jax.sharding import PartitionSpec as P

    from lip2speech_torch.config import ModelConfig
    from lip2speech_torch.models.lip2speech import Lip2Speech
    from lip2speech_torch.parallel import tensor
    from lip2speech_tpu.config import ModelConfig as JModelConfig
    from lip2speech_tpu.parallel import create_mesh, partition_params
    from torch_port_common import small_configs

    jc, tc = small_configs() if size == "small" else (JModelConfig(), ModelConfig())
    params = _jax_param_shapes(jc)["params"]
    mesh = create_mesh(n_data=2, n_model=n_model, devices=jax.devices()[: 2 * n_model])
    specs = partition_params(params, mesh, True)
    names = _torch_names(tc)
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        if spec != P():
            key = ("params",) + tuple(str(getattr(k, "key", k)) for k in path)
            assert list(spec)[-1] == "model" and all(s is None for s in list(spec)[:-1])
            want[names[key]] = 0  # the flax kernel's last dim is the torch layout's first
    with torch.device("meta"):
        model = Lip2Speech(tc, face_net=False)
    got = tensor.partition_params({n: tuple(p.shape) for n, p in model.named_parameters()},
                                  n_model)
    assert got == want
    assert len(got) == (11 if n_model == 2 else 1)


def test_rank_state_dict_equals_jax_addressable_shards():
    """``weights.rank_from_flax`` for each model index equals the shards
    ``shard_pytree`` puts on a 4 x 2 virtual mesh (``device_put`` only), in
    the port's layout; the unsharded tensors equal ``from_flax``'s."""
    import jax

    from lip2speech_torch import weights
    from lip2speech_tpu.parallel import create_mesh, partition_params, shard_pytree
    from torch_port_common import fill_tree, small_configs

    jc, tc = small_configs()
    shapes = _jax_param_shapes(jc)
    tree = fill_tree(shapes, 3)
    mesh = create_mesh(n_data=4, n_model=2)
    placed = shard_pytree(tree["params"], mesh, partition_params(tree["params"], mesh, True))
    names = _torch_names(tc)
    whole = weights.from_flax(tree, tc)
    ranks = [weights.rank_from_flax(tree, tc, m, 2) for m in range(2)]
    model_of = {d: m for (_, m), d in np.ndenumerate(mesh.devices)}
    n_sharded = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        key = ("params",) + tuple(str(getattr(k, "key", k)) for k in path)
        name = names.get(key)
        if name is None or not name.endswith(".weight") or leaf.sharding.is_fully_replicated:
            continue
        n_sharded += 1
        for s in leaf.addressable_shards:
            kernel = np.asarray(s.data)
            # flax (*k, in, out) -> torch (out, in, *k)
            local = np.moveaxis(kernel, (-1, -2), (0, 1))
            assert np.array_equal(ranks[model_of[s.device]][name].numpy(), local), name
    assert n_sharded == 11
    sharded = {n for n in whole if ranks[0][n].shape != whole[n].shape}
    assert len(sharded) == 11
    for m in range(2):
        assert all(torch.equal(ranks[m][n], v) for n, v in whole.items() if n not in sharded)


@pytest.mark.parametrize("n_model", [1, 2, 4])
@pytest.mark.parametrize("requested", [-1, 1, 2, 4, 8])
def test_grid_size_rule_matches_create_mesh(n_model, requested):
    """On the 8 virtual devices as 8 processes: the port accepts a grid
    exactly where ``create_mesh`` does, with the same data axis; -1 is
    ``auto_mesh``'s data axis for a batch that it divides."""
    from lip2speech_torch.parallel.dist import data_parallel_size
    from lip2speech_tpu.parallel import auto_mesh, create_mesh

    try:
        want = create_mesh(n_data=requested, n_model=n_model).shape["data"]
    except (ValueError, AssertionError):
        want = None
    try:
        got = data_parallel_size(requested, 8, 64, n_model)
    except ValueError:
        got = None
    assert got == want
    if requested == -1:
        assert got == auto_mesh(64, n_model).shape["data"]
    with pytest.raises(ValueError, match="does not split"):
        data_parallel_size(-1, 8, 8 // n_model + 1, n_model)


if __name__ == "__main__":
    sys.exit(fork_ranks(sys.argv[1], sys.argv[2], sys.argv[3]))
