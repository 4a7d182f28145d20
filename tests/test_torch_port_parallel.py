"""The port's data and tensor parallelism (``tailored_avsr_tpu_torch/parallel/``)
against the JAX package's mesh, on the CPU.

The port's side runs in two gloo ranks (``tests/torch_port_parallel_ranks.py``),
spawned once for the module: every scenario runs in them in one go, while
this process runs the JAX sides (jitted, on ``make_mesh(2)`` /
``make_mesh(2, model_parallel=2)`` over the virtual CPU devices of
``tests/conftest.py``) and ``dryrun_multichip(4, "cpu")``. Every rate is 0 (tiny
flagship, ``_train_cfg``).

Tolerances (|got - want| <= atol + rtol |want|):
- gradients: each entry within 1e-4 of its tensor's largest JAX entry plus
  1e-5 of the model's largest (``tests/test_torch_port_train.py``'s rule:
  f32 sums in other orders, and the all-reduce adds the ranks' parts);
- BatchNorm running statistics after the micro-step: 1e-5 of each
  tensor's largest entry;
- stats (losses, accuracy): 1e-5 relative;
- decoding: ids and texts equal, n-best scores within 1e-4;
- the CLI through two ranks against one: the JAX package's own rule for
  its mesh (``tests/test_pod_inference.py::_cli_train_parity``): rtol
  2e-3, atol 2e-5, at most max(2, 1 in 10,000) elements outside (Adam's
  first update moves a near-zero gradient's entry by a whole step when the
  order of the sums flips its sign).
"""

import copy
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as graft
from tailored_avsr_tpu.parallel import host_data as jax_host_data
from tailored_avsr_tpu.parallel.mesh import make_mesh, replicate, shard_train_state
from tailored_avsr_tpu.parallel.mesh import tp_param_spec as jax_tp_param_spec
from tailored_avsr_tpu.tasks.avsr import AVSRTask
from tailored_avsr_tpu_torch.parallel import host_data, tp_param_spec
from tailored_avsr_tpu_torch.parallel.dryrun import dryrun_multichip
from tailored_avsr_tpu_torch.tasks.avsr import build_meta
from tailored_avsr_tpu_torch.tasks.common import build_model
from tailored_avsr_tpu_torch.utils.convert import convert_jax_variables
from tailored_avsr_tpu_torch.utils.torch_compat import export_torch_state_dict, torch_axis_of_flax_last, torch_key_for
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_slice import TOKENS, _random_variables
from tests.test_torch_port_train import TOKEN_LIST, _cli_config, _train_cfg

RNGS = ("dropout", "skip", "specaug")


def _train_batch(b: int, frames: int = 6, text_len: int = 5) -> tuple:
    """b utterances, every other one a frame shorter and with two fewer
    characters."""
    rs = np.random.RandomState(3)
    samples = frames * 640
    tl = np.array([text_len - 2 * (i % 2) for i in range(b)], np.int32)
    text = rs.randint(3, len(TOKEN_LIST) - 1, (b, text_len)).astype(np.int32)
    for i in range(b):
        text[i, tl[i]:] = -1
    return ((rs.randn(b, samples) * 0.1).astype(np.float32),
            np.array([samples - 640 * (i % 2) for i in range(b)], np.int32),
            rs.randn(b, frames, 88, 88).astype(np.float32),
            np.array([frames - (i % 2) for i in range(b)], np.int32), text, tl)


def _serve_batch(b: int) -> dict:
    rs = np.random.RandomState(0)
    samples = 8 * 640
    return {"audio": (rs.randn(b, samples) * 0.1).astype(np.float32),
            "audio_lengths": np.array([samples - 640 * (i % 2) for i in range(b)], np.int32),
            "video": rs.randn(b, 8, 88, 88).astype(np.float32),
            "video_lengths": np.array([8 - (i % 2) for i in range(b)], np.int32)}


def _jax_micro_step(jm, variables, batch, mesh) -> dict:
    """JAX's train step on the mesh (``shard_train_state``; the batch split
    over 'data' when it divides, else replicated, as the JAX CLI places
    it): the gradient and the BatchNorm statistics it moves to."""
    import optax

    from tailored_avsr_tpu.train.loop import create_train_state

    state = shard_train_state(create_train_state(variables, optax.adam(1e-3)), mesh)
    spec = P("data") if batch[0].shape[0] % mesh.shape["data"] == 0 else P()
    args = tuple(jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec)) for a in batch)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(RNGS)}

    @jax.jit
    def grads(params, batch_stats, *b):
        def loss(p):
            (l, stats), new = jm.apply({"params": p, "batch_stats": batch_stats}, *b, deterministic=False,
                                       rngs=rngs, mutable=["batch_stats"])
            return l, (stats, new["batch_stats"])

        (_, (stats, bs)), g = jax.value_and_grad(loss, has_aux=True)(params)
        return g, bs, {k: v for k, v in stats.items() if getattr(v, "ndim", 1) == 0}

    with mesh:
        g, bs, stats = jax.device_get(grads(state.params, state.batch_stats, *args))
    return {"grads": export_torch_state_dict({"params": g}),
            "batch_stats": {k: v for k, v in export_torch_state_dict({"batch_stats": bs}).items()
                            if "running_" in k},
            "stats": {k: float(v) for k, v in stats.items()}}


def _jax_engine_results(cfg, variables, requests) -> dict:
    from tailored_avsr_tpu.inference import Speech2Text as JaxSpeech2Text

    mesh = make_mesh(2)
    js = JaxSpeech2Text(cfg, mesh=mesh)
    js.variables = replicate(jax.tree_util.tree_map(np.asarray, variables), mesh)  # as ensure_params places them
    return {name: {"greedy": js.greedy(b), "nbest": js.nbest(b)} for name, b in requests.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the two ranks, run the JAX sides and the single-process port
    sides meanwhile, then read the ranks' results."""
    from tests.synthetic import make_synthetic_corpus

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("parallel")
    jax_cfg = _train_cfg()
    jm = AVSRTask.build_model(jax_cfg, TOKEN_LIST)
    batches = {"even": _train_batch(4), "odd": _train_batch(3)}
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)},
                                            *batches["even"]))
    variables = _random_variables(shapes, seed=4)
    ctx = None
    try:
        # XLA compiles without the interpreter lock, tracing takes it: the longest JAX
        # graph starts first, the others once the ranks are under way; all compile side
        # by side, beside the four ranks of the dry run
        with ThreadPoolExecutor(max_workers=5) as pool:
            jax_tp = pool.submit(_jax_micro_step, jm, variables, batches["even"], make_mesh(2, model_parallel=2))
            serve_cfg = graft._flagship_cfg(tiny=True)
            serve_cfg.token_list = TOKENS
            serve_cfg.inference_conf = dict(serve_cfg.inference_conf, beam_size=3, nbest=2, unroll=1)
            requests = {"even": _serve_batch(2), "odd": _serve_batch(3)}
            sjm = AVSRTask.build_model(serve_cfg, TOKEN_LIST)
            sargs = tuple(requests["even"][k] for k in ("audio", "audio_lengths", "video", "video_lengths"))
            serve_vars = _random_variables(jax.eval_shape(lambda: sjm.init(
                {"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)}, *sargs,
                np.ones((2, 4), np.int32), np.full((2,), 4, np.int32))), seed=3)
            train_cfg = copy.copy(jax_cfg)
            train_cfg.specaug = graft._flagship_cfg(tiny=True).specaug  # for the SpecAug case; JAX runs without
            weights, dropped = convert_jax_variables(variables, build_meta(jax_cfg, list(TOKEN_LIST)))
            assert dropped == []
            serve_weights, _ = convert_jax_variables(serve_vars, build_meta(serve_cfg, list(TOKEN_LIST)))
            csv_path, token_path = make_synthetic_corpus(str(tmp / "corpus"), n=4)
            cli_cfg = _zero_rates(_cli_config(tmp, token_path, epochs=1, average_epochs=1, batch_size=3,
                                              accum_grad=2, data_parallel=True))
            (tmp / "resume").mkdir()
            resume_cfg = _zero_rates(_cli_config(tmp / "resume", token_path, epochs=2, average_epochs=1,
                                                 batch_size=3, accum_grad=2, data_parallel=True, model_parallel=2))

            def cli_args(out, cfg=cli_cfg):
                return ["--config-file", cfg, "--training-dataset", csv_path, "--validation-dataset", csv_path,
                        "--test-dataset", csv_path, "--mode", "training", "--output-dir", str(tmp / out),
                        "--output-name", out, "--device", "cpu"] + (["--resume"] if cfg == resume_cfg else [])

            torch.save({"tokens": TOKEN_LIST, "train_cfg": train_cfg, "train_weights": weights,
                        "train_batches": batches, "serve_cfg": serve_cfg, "serve_weights": serve_weights,
                        "requests": requests, "cli_args": cli_args("two_ranks"),
                        "tp_resume_args": cli_args("tp_resume", resume_cfg)}, tmp / "payload.pt")
            ctx = mp.start_processes(ranks.rank_main, args=(2, str(tmp)), nprocs=2, join=False,
                                     start_method="spawn")
            jax_dp = {name: pool.submit(_jax_micro_step, jm, variables, b, make_mesh(2)) for name, b in batches.items()}
            jax_serve = pool.submit(_jax_engine_results, serve_cfg, serve_vars, requests)
            dryrun = pool.submit(dryrun_multichip, 4, "cpu")
            out = {"port_specaug": ranks.train_micro_step(train_cfg, TOKEN_LIST, weights, batches["even"], None,
                                                          specaug=True)}
            ranks.cli(cli_args("one_rank"))
            # one process resumes the two ranks' training state while they resume it under model_parallel 2
            while not (tmp / "resume_ready").exists():
                if ctx.join(timeout=1):
                    raise AssertionError("the ranks ended before their training state was ready to resume")
            ranks.cli(cli_args("one_resume", resume_cfg))
            out["jax_dp"] = {name: f.result() for name, f in jax_dp.items()}
            out["jax_tp"], out["jax_serve"] = jax_tp.result(), jax_serve.result()
            out["dryrun"] = dryrun.result()
    finally:
        while ctx is not None and not ctx.join(timeout=600):
            pass
        torch.set_num_threads(threads)
    out["ranks"] = torch.load(tmp / "results.pt", weights_only=False)
    out["tmp"] = tmp
    return out


def _zero_rates(path: str) -> str:
    """The config at ``path`` with every dropout rate 0 (dropout masks are
    each rank's own draws, as they differ between the packages)."""
    import yaml

    def zero(node):
        if isinstance(node, dict):
            return {k: 0.0 if k.endswith("dropout_rate") else zero(v) for k, v in node.items()}
        return node

    with open(path) as f:
        c = zero(yaml.safe_load(f))
    with open(path, "w") as f:
        yaml.safe_dump(c, f)
    return path


def _same_grads(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    floor = 1e-5 * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=floor + 1e-4 * float(np.abs(w).max()),
                                   err_msg=name)


def _same_batch_stats(got: dict, want: dict) -> None:
    assert set(got) == set(want) and want
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5 * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("batch", ["even", "odd"])
def test_data_parallel_gradient_matches_the_jax_mesh_step(world, batch):
    """Two ranks, a global batch of 4 (2 rows a rank) and of 3 (2 and 1, the
    remainder rule): the all-reduced gradient is the JAX mesh step's, every
    leaf; the stats are the global batch's."""
    got, want = world["ranks"][f"dp_{batch}"], world["jax_dp"][batch]
    _same_grads(got["grads"], want["grads"])
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("batch", ["even", "odd"])
def test_data_parallel_batchnorm_statistics_match_the_jax_mesh_step(world, batch):
    """The lip frontend's BatchNorm statistics after the micro-step are the
    global batch's (sum, sum of squares and count all-reduced), as the
    JAX mesh step's, and every replica holds the same parameters after the
    update (bit for bit)."""
    got = world["ranks"][f"dp_{batch}"]
    _same_batch_stats(got["batch_stats"], world["jax_dp"][batch]["batch_stats"])
    assert got["replicas_equal"]


def test_specaug_rows_are_the_global_draws_rows(world):
    """Each rank's SpecAug uniforms are its rows of the global batch's draw,
    and its generator moves past the whole draw; with SpecAug on, the two
    ranks' gradient is the single-process gradient of the global batch
    (1e-4 of each tensor's largest entry)."""
    assert world["ranks"]["specaug_rows"]
    got, want = world["ranks"]["dp_specaug"], world["port_specaug"]
    _same_grads(got["grads"], want["grads"])
    assert got["replicas_equal"]


def test_tensor_parallel_gradient_matches_the_jax_tp_step(world):
    """``model_parallel: 2`` over two ranks: the split leaves' gradients,
    gathered, and every replicated leaf's are the JAX step's on
    ``make_mesh(2, model_parallel=2)``; so are the BatchNorm statistics."""
    assert world["ranks"]["tp_grid"] == {"data": 1, "model": 2}
    got, want = world["ranks"]["tp"], world["jax_tp"]
    _same_grads(got["grads"], want["grads"])
    _same_batch_stats(got["batch_stats"], want["batch_stats"])
    assert got["replicas_equal"]


@pytest.mark.parametrize("batch", ["even", "odd"])
def test_speech2text_data_parallel_matches_the_jax_mesh_engine(world, batch):
    """``data_parallel: true`` over two ranks (each decodes its rows; a batch
    of 3 is decoded whole by both) against the JAX engine over a 2-device
    mesh: greedy texts equal, n-best ids and texts equal, scores 1e-4."""
    got, want = world["ranks"]["serve"][batch], world["jax_serve"][batch]
    assert got["greedy"] == want["greedy"]
    assert len(got["nbest"]) == len(want["nbest"]) == len(_serve_batch(2 if batch == "even" else 3)["audio"])
    for g_hyps, w_hyps in zip(got["nbest"], want["nbest"]):
        assert [h[2] for h in g_hyps] == [h[2] for h in w_hyps]
        assert [h[0] for h in g_hyps] == [h[0] for h in w_hyps]
        np.testing.assert_allclose([h[3] for h in g_hyps], [h[3] for h in w_hyps], atol=1e-4, rtol=0)


def _same_cli_runs(tmp, one: str, other: str, epoch: int) -> None:
    """``other``'s Adam first moments (the gradients' running mean) within
    this file's gradient tolerance of ``one``'s, and its
    ``model_{epoch}.pth`` within the JAX package's mesh tolerance."""
    mu = [torch.load(tmp / run / "models" / "train_state.pt", weights_only=True)["optimizer"]["mu"]
          for run in (one, other)]
    _same_grads({k: v.numpy() for k, v in mu[1].items()}, {k: v.numpy() for k, v in mu[0].items()})
    a = torch.load(tmp / one / "models" / f"model_{epoch:03d}.pth", weights_only=True)
    b = torch.load(tmp / other / "models" / f"model_{epoch:03d}.pth", weights_only=True)
    assert set(a) == set(b)
    total = bad = 0
    for k in a:
        x, y = a[k].double().numpy(), b[k].double().numpy()
        total += x.size
        bad += int((~np.isclose(x, y, rtol=2e-3, atol=2e-5)).sum())
    assert bad <= max(2, total // 10000), (bad, total)


def test_cli_through_two_ranks_matches_one(world):
    """``avsr_main`` with ``data_parallel: true`` through two ranks (batches
    of 3 and 1: an uneven split, then a batch kept whole on both ranks;
    ``accum_grad`` 2, so one update from both batches' gradients) against
    the same command in one process: ``model_001.pth`` within the JAX
    package's mesh tolerance, written by rank 0 alone, and the Adam first
    moments (the gradients' running mean) within this file's gradient
    tolerance."""
    tmp = world["tmp"]
    _same_cli_runs(tmp, "one_rank", "two_ranks", 1)
    assert sorted(os.listdir(tmp / "two_ranks" / "models")) == ["model_001.pth", "model_average.pth",
                                                                 "train_state.pt"]


def test_cli_resume_under_tensor_parallelism_matches_one_process(world):
    """The two ranks' training state after epoch 1, resumed for epoch 2
    through the same two ranks with ``model_parallel: 2`` (every rank
    loads the single-process file and keeps its own shards) and in one
    process: the same rules as the CLI test above, on ``model_002.pth``."""
    _same_cli_runs(world["tmp"], "one_resume", "tp_resume", 2)


def test_dropout_masks_are_each_ranks_own(world):
    """A train step with dropout 0.5 over two data ranks: each rank's rows
    draw their own masks. Over a model group of two: the dropout on
    replicated activations draws alike on both ranks, and the split
    feed-forward's dropout draws each rank's own mask for its hidden units."""
    dp, tp = world["ranks"]["dropout_dp"], world["ranks"]["dropout_tp"]
    for masks in (*dp, *tp):
        assert 0 < masks["replicated"].mean() < 1 and 0 < masks["hidden"].mean() < 1
    assert not np.array_equal(dp[0]["replicated"], dp[1]["replicated"])
    assert not np.array_equal(dp[0]["hidden"], dp[1]["hidden"])
    assert np.array_equal(tp[0]["replicated"], tp[1]["replicated"])
    assert not np.array_equal(tp[0]["hidden"], tp[1]["hidden"])


@pytest.mark.parametrize("n,world_size", [(n, w) for n in (1, 3, 4, 7) for w in (1, 2, 3, 4)])
def test_process_batch_slice_matches_jax(monkeypatch, n, world_size):
    """Every rank's slice, from the group or given, equals the JAX package's
    with ``jax.process_count`` / ``process_index`` set to the same."""
    for rank in range(world_size):
        monkeypatch.setattr(jax, "process_count", lambda: world_size)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        assert host_data.process_batch_slice(n, rank, world_size) == jax_host_data.process_batch_slice(n)


@pytest.mark.parametrize("model_parallel", [2, 3])
def test_tp_param_spec_names_the_jax_leaves_and_dimensions(model_parallel):
    """The port's rule over the tiny flagship's parameters against the JAX
    rule over its flax tree, carried to the port's names by the key-grammar
    export: the same leaves split, along the same dimension (a flax kernel's
    output is torch's dim 0), under the same divisibility (3 divides 96
    and not 64)."""
    cfg = _train_cfg()
    jm = AVSRTask.build_model(cfg, TOKEN_LIST)
    params = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "mlm": jax.random.PRNGKey(1)},
                                            *_train_batch(2)))["params"]
    want = {}
    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        spec = tuple(jax_tp_param_spec(path, x, model_parallel))
        dim = None
        if "model" in spec:
            axis = spec.index("model")
            last = torch_axis_of_flax_last(keys[-1], x.ndim)
            dim = last if axis == x.ndim - 1 else 1 - last
        want[torch_key_for(keys, params)] = dim
    model = build_model(cfg, TOKEN_LIST, device="cpu")
    got = {n: tp_param_spec(n, tuple(p.shape), model_parallel) for n, p in model.named_parameters()}
    assert got == want
    assert any(v is not None for v in got.values()) and any(v is None for v in got.values())


def test_bn_axis_name_builds_serves_and_its_train_step_raises_as_jax():
    """The JAX VSR model with ``bn_axis_name`` builds, and its train forward
    raises ``NameError`` (nothing binds the axis name); the port's builds,
    serves exactly as without it, and its train forward raises the same."""
    from tailored_avsr_tpu.tasks.asr import ASRTask
    from tests.test_torch_port_branchformer import VSR, speech_batch, tiny_cfg

    cfg = tiny_cfg(VSR)
    cfg.frontend_conf = dict(cfg.frontend_conf or {}, bn_axis_name="batch")
    batch = speech_batch("vsr")
    args = tuple(batch[k] for k in ("speech", "speech_lengths", "text", "text_lengths"))
    jm = ASRTask.build_model(cfg, TOKEN_LIST)
    variables = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, *args))  # builds
    with pytest.raises(NameError, match="unbound axis name: batch"):  # raised while tracing the train step
        jax.eval_shape(lambda v: jm.apply(v, *args, deterministic=False, mutable=["batch_stats"],
                                          rngs={k: jax.random.PRNGKey(0) for k in RNGS}), variables)
    plain = tiny_cfg(VSR)
    with_name = build_model(cfg, TOKEN_LIST, device="cpu", generator=torch.Generator().manual_seed(0))
    without = build_model(plain, TOKEN_LIST, device="cpu", generator=torch.Generator().manual_seed(0))
    x = tuple(torch.from_numpy(a) for a in args[:2])
    with torch.no_grad():
        for got, want in zip(with_name.ctc_greedy(*x), without.ctc_greedy(*x)):
            assert torch.equal(got, want)
    with_name.train()
    with pytest.raises(NameError, match="unbound axis name: batch"):
        with_name(*(torch.from_numpy(a) for a in args))


def test_dryrun_multichip_4(world):
    """``dryrun_multichip(4)`` (run by the module's fixture beside the other
    ranks): four gloo ranks on a (2, 2) grid, a data- and tensor-parallel
    train step, a greedy and a beam decode over the ranks, and the full
    flagship's shards on the meta device checked against ``tp_param_spec``."""
    out = world["dryrun"]
    assert (out["backend"], out["device"]) == ("gloo", "cpu")
    assert out["grid"] == {"data": 2, "model": 2}
    assert np.isfinite(out["loss"]) and len(out["greedy"]) == len(out["beam"]) == 2
    assert out["full_split_leaves"] > 0
