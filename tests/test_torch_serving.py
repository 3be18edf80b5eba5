"""The PyTorch port's serving slice against the JAX package, and its entry
point's rules: `HSTUModelFamily.predict` and `predict_mfalcon` on the debug
preset at small widths (JAX weights carried over, quantized and not), and at
qk = linear = 136 and 256, widths past the narrow forward's V 128 (the wide
forward's on the card), the random dataset's draws, the int8 table
quantization, the serving CLI on the CPU (also at --attn_dim 136), the
refusal to fall back to the CPU, and the port's independence of JAX.
Predictions are float32 sigmoids; atol = rtol = 1e-5."""

import ast
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generative_recommenders_tpu.configs import dlrm as j_configs
from generative_recommenders_tpu.data.dlrm_dataset import DLRMv3RandomDataset as JaxDataset
from generative_recommenders_tpu.inference import model_family as j_family
from generative_recommenders_tpu.modules.dlrm_hstu import DlrmHSTU as JaxDlrmHSTU
from generative_recommenders_tpu_torch.configs import dlrm as t_configs
from generative_recommenders_tpu_torch.convert import params_from_flax
from generative_recommenders_tpu_torch.data.dlrm_dataset import DLRMv3RandomDataset
from generative_recommenders_tpu_torch.inference import model_family as t_family
from generative_recommenders_tpu_torch.modules.dlrm_hstu import DlrmHSTU

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "generative_recommenders_tpu_torch"
SMALL = dict(
    hstu_attn_num_layers=2, hstu_embedding_table_dim=16, hstu_transducer_embedding_dim=32,
    hstu_attn_linear_dim=16, hstu_attn_qk_dim=16, hstu_num_heads=2,
    num_position_buckets=128, num_time_buckets=64,
    # keep the contextual features' min-uih-length rule on at this uih size
    contextual_feature_to_min_uih_length=(("viewer_id", 10), ("dummy_contexual", 10)),
)
CLI_SMALL = [
    "--batch_size", "4", "--max_uih_len", "24", "--max_num_candidates", "6",
    "--num_layers", "2", "--transducer_dim", "32", "--table_dim", "16",
    "--attn_dim", "16", "--num_heads", "2", "--hash_size", "100",
    "--num_qsl_batches", "2", "--num_queries", "6", "--num_warmups", "1",
]


def _configs(M=6, **widths):
    small = dict(SMALL, **widths)
    jcfg = dataclasses.replace(j_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=M), **small)
    tcfg = dataclasses.replace(t_configs.get_hstu_configs("debug", max_uih_len=24, max_num_candidates=M), **small)
    return jcfg, tcfg


def _models(**widths):
    """The JAX model and the port's on its weights, and a batch of 4."""
    jcfg, tcfg = _configs(**widths)
    jm = JaxDlrmHSTU(jcfg, j_configs.get_embedding_table_config("debug", hash_size=64, dim=16))
    uih, ul, cands, nc = JaxDataset(jcfg, hash_size=64, batch_size=4, seed=0).batch()
    params = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a, True))(uih, ul, cands, nc)
    tm = DlrmHSTU(tcfg, t_configs.get_embedding_table_config("debug", hash_size=64, dim=16))
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm, (uih, ul, cands, nc)


@pytest.fixture(scope="module")
def models():
    return _models()


# head widths past the narrow forward's V 128: on the card every layer's
# forward takes the wide forward (the `--attn_dim 256` serving path)
WIDE_ATTN = (136, 256)


@pytest.fixture(scope="module", params=WIDE_ATTN, ids=[f"attn{w}" for w in WIDE_ATTN])
def wide_models(request):
    return (*_models(hstu_attn_qk_dim=request.param, hstu_attn_linear_dim=request.param), request.param)


def _torch(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


@pytest.mark.parametrize("mfalcon", [False, True])
@pytest.mark.parametrize("quantize", [False, True])
def test_family_predictions_match_jax(models, quantize, mfalcon):
    jm, params, tm, (uih, ul, cands, nc) = models
    jf = j_family.HSTUModelFamily(jm, params, quantize=quantize)
    tf = t_family.HSTUModelFamily(tm, quantize=quantize)
    if mfalcon:
        qt = cands["item_query_time"][:, 0]
        want = jf.predict_mfalcon(uih, ul, cands, qt, microbatch=4)
        got = tf.predict_mfalcon(_torch(uih), torch.as_tensor(ul), _torch(cands), torch.as_tensor(qt), microbatch=4)
    else:
        want = jf.predict(uih, ul, cands, nc)
        args = (_torch(uih), torch.as_tensor(ul), _torch(cands), torch.as_tensor(nc))
        got = tf.predict(*args)
        if not quantize:  # the float family is the model's own forward
            with torch.no_grad():
                torch.testing.assert_close(tm(*args, compute_losses=False)[3], got)
    assert got.shape == (1, 4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mfalcon", [False, True])
def test_family_predictions_match_jax_at_wide_heads(wide_models, mfalcon):
    """The served family (int8 tables) at qk = linear = 136 and 256, 2 layers
    of 2 heads: dense predictions and M-FALCON's against the JAX family."""
    jm, params, tm, (uih, ul, cands, nc), width = wide_models
    assert tm.hstu_transducer.stu_module.layer_0.uvqk_weight.shape[1] == 2 * 4 * width  # 2 heads of u, v, q, k
    jf = j_family.HSTUModelFamily(jm, params, quantize=True)
    tf = t_family.HSTUModelFamily(tm, quantize=True)
    if mfalcon:
        qt = cands["item_query_time"][:, 0]
        want = jf.predict_mfalcon(uih, ul, cands, qt, microbatch=4)
        got = tf.predict_mfalcon(_torch(uih), torch.as_tensor(ul), _torch(cands), torch.as_tensor(qt), microbatch=4)
    else:
        want = jf.predict(uih, ul, cands, nc)
        got = tf.predict(_torch(uih), torch.as_tensor(ul), _torch(cands), torch.as_tensor(nc))
    assert got.shape == (1, 4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dataset_and_quantization_match_jax():
    jcfg, tcfg = _configs()
    want = JaxDataset(jcfg, hash_size=1000, batch_size=5, seed=3).batch()
    got = DLRMv3RandomDataset(tcfg, hash_size=1000, batch_size=5, seed=3).batch()
    for w, g in zip(want, got):
        if isinstance(w, dict):
            assert w.keys() == g.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        else:
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(0)
    table = (rng.standard_normal((64, 16)) * 0.05).astype(np.float32)
    table[3] = 0.0  # an all-zero row hits the scale floor
    jq, js = j_family.quantize_table(jnp.asarray(table))
    tq, ts = t_family.quantize_table(torch.as_tensor(table))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.skipif(shutil.which("g++") is None, reason="the load generator needs g++")
@pytest.mark.parametrize("mfalcon", [False, True])
def test_serving_cli_on_cpu(mfalcon):
    from generative_recommenders_tpu_torch.inference import main as serve

    result = serve.main(["--device", "cpu", "--scenario", "Offline", *CLI_SMALL]
                        + (["--mfalcon", "--candidates_per_chunk", "4"] if mfalcon else []))
    assert result["qps"] > 0 and result["query_count"] == 6
    # 6 queries cycle through the 2 QSL batches; only real candidates count
    _, tcfg = _configs()
    live = [int(nc.sum()) for *_, nc in DLRMv3RandomDataset(tcfg, hash_size=100, batch_size=4).batches(2)]
    assert sum(live) < 2 * 4 * 6
    assert result["scored_candidates_per_s"] == pytest.approx(result["qps"] * sum(live) / 2)


@pytest.mark.skipif(shutil.which("g++") is None, reason="the load generator needs g++")
@pytest.mark.parametrize("mfalcon", [False, True])
def test_serving_cli_on_cpu_at_attn_dim_136(mfalcon):
    """The serving CLI at --attn_dim 136 (qk = linear = 136, the wide
    forward's widths on the card), dense and M-FALCON: every query served,
    the real candidates counted."""
    from generative_recommenders_tpu_torch.inference import main as serve

    argv = list(CLI_SMALL)
    argv[argv.index("--attn_dim") + 1] = "136"
    result = serve.main(["--device", "cpu", "--scenario", "Offline", *argv]
                        + (["--mfalcon", "--candidates_per_chunk", "4"] if mfalcon else []))
    assert result["qps"] > 0 and result["query_count"] == 6
    _, tcfg = _configs(hstu_attn_qk_dim=136, hstu_attn_linear_dim=136)
    live = [int(nc.sum()) for *_, nc in DLRMv3RandomDataset(tcfg, hash_size=100, batch_size=4).batches(2)]
    assert result["scored_candidates_per_s"] == pytest.approx(result["qps"] * sum(live) / 2)


def test_serving_cli_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from generative_recommenders_tpu_torch.inference import main as serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(CLI_SMALL)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port (the serving, ranker-training and research
    stacks, the data paths, the distribution layer: whatever lies under the
    package) and
    `chip_smoke.py`; nor pandas, which the card's machine does not have."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'generative_recommenders_tpu')]\n"
        "assert not bad, bad\n"
    )
    for stack in ("models.sequential", "models.hstu", "train.train_loop", "train.eval_metrics",
                  "data.features", "configs.research", "cli.train_research",
                  "ops.cuda.hstu_attention_relbias", "data.preprocessor", "data.reco_dataset",
                  "data.dlrm_public_datasets", "cli.preprocess_dlrm_data", "cli.run_fractal_expansion",
                  "parallel.distributed", "parallel.mesh", "parallel.sharding", "parallel.embedding",
                  "parallel.train"):
        assert f"generative_recommenders_tpu_torch.{stack}" in modules
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)

    for path in list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "optax", "pandas", "generative_recommenders_tpu"
                ), f"{path}: imports {name}"
