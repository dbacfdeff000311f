"""The port's entry points (missm_tpu_torch.cli.{train,test,predict},
compat.{args,yaml_config}) with --device cpu, after the JAX package's
tests/test_cli_smoke.py, test_cli_distill.py, test_cli_predict.py,
test_checkpoint_fixture.py:95, test_yaml_config.py and
test_preemption.py:209, and held against the JAX package's:

- the parsers' flags and defaults equal missm_tpu.compat.args's, but
  --device (cuda here, tpu there); every flag whose feature is not ported
  raises when given anything but its default;
- cli.test's reports against missm_tpu.cli.test's on the same params
  (built in JAX, bridged with from_jax, each saved with its own package's
  save_checkpoint as final_model/mvsa_sum), f32, the same JPEG tree: every
  report line identical but the numbers, accuracy equal and loss, F1 and
  AUC within 1e-4 (one unit in the printed 4th decimal; the two packages
  decode and resize the JPEGs with different f32 code, within 2e-4 of each
  other, tests/test_torch_data.py).
"""
import argparse
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from missm_tpu_torch.compat.args import test_args, train_args
from tests.synthetic import make_mvsa_tree

pytestmark = pytest.mark.filterwarnings("ignore")

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "lb_ckpt")
REPORT_ATOL = 1e-4
TINY = ["--modality_types", "language", "image", "--model_scale", "tiny",
        "--hash_tokenizer", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny, and the suite's workers
    share the cores (torch's default of one thread a core each makes them
    spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def workspace(tmp_path, monkeypatch):
    csv = make_mvsa_tree(str(tmp_path / "mvsa_multiple"), write_media=True)
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    return csv


def _train_argv(csv, fusion="sum", *extra):
    return ["--datasetName", "mvsa", "--csv_path", csv, "--fusion_type",
            fusion, *TINY, "--init", "random", "--batch_size", "4",
            "--num_epochs", "1", "--num_workers", "0", *extra]


def _test_argv(csv, *extra):
    return ["--datasetName", "mvsa", "--csv_path", csv, "--fusion_type",
            "sum", "--test_types", "sum", "--test_missing_type", "language",
            "image", "mixed", *TINY, "--batch_size", "8", *extra]


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------

def test_train_then_test_cli(workspace):
    from missm_tpu_torch.cli.test import main as test_main
    from missm_tpu_torch.cli.train import main as train_main

    # --frozen_bf16 also runs the cast_frozen_params wiring
    best, hist = train_main(_train_argv(workspace, "sum", "--frozen_bf16"))
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    assert os.path.isdir("./final_model/mvsa_sum")
    assert os.path.isdir("./experiments/mvsa_sum/checkpoints")

    results = test_main(_test_argv(workspace))
    assert set(results["sum"]) == {"language", "image", "mixed"}
    for mt, per_ratio in results["sum"].items():
        assert len(per_ratio) == 10
        assert all(np.isfinite(m["accuracy"]) for m in per_ratio.values())
        assert os.path.exists(f"./new_txt_experiment/mvsa_sum_{mt}.txt")


def test_train_cli_profile_dir(workspace, tmp_path):
    from missm_tpu_torch.cli.train import main as train_main

    prof = str(tmp_path / "trace")
    train_main(_train_argv(workspace, "sum", "--batch_size", "2",
                           "--profile_dir", prof))
    assert os.path.exists(os.path.join(prof, "train_trace.json"))


def test_teacher_then_students(workspace):
    """The two-phase distillation flow (train_ddp.py:191-196): MTD_stu and
    KL_stu load the Distill_tea final model as encoder and teacher."""
    from missm_tpu_torch.cli.train import main as train_main
    from missm_tpu_torch.train.checkpoint import restore_checkpoint

    train_main(_train_argv(workspace, "Distill_tea"))
    assert os.path.isdir("./final_model/mvsa_Distill_tea")
    tea, _ = restore_checkpoint("./final_model/mvsa_Distill_tea")
    for fusion in ("MTD_stu", "KL_stu"):
        best, hist = train_main(_train_argv(workspace, fusion))
        assert np.isfinite(hist[0]["train_loss"])
        assert os.path.isdir(f"./final_model/mvsa_{fusion}")
        # the student trained from the teacher's encoder: its frozen
        # leaves are the teacher's
        blocks = best["encoder"]["image"]["vision"]["blocks"]
        assert torch.equal(
            blocks[0]["mlp"]["fc1"]["w"],
            tea["params"]["encoder"]["image"]["vision"]["blocks"][0]["mlp"]
            ["fc1"]["w"])


def test_predict_cli(workspace):
    import pandas as pd

    from missm_tpu_torch.cli.predict import main as predict_main
    from missm_tpu_torch.cli.train import main as train_main

    train_main(_train_argv(workspace))
    argv = ["--datasetName", "mvsa", "--csv_path", workspace,
            "--fusion_type", "sum", *TINY, "--batch_size", "8"]
    out = predict_main(argv + ["--split", "test", "--output", "preds.csv"])
    df = pd.read_csv("preds.csv")
    assert len(df) == len(out) == 10
    assert set(df.columns) == {"index", "label", "pred", "confidence"}
    assert (df["confidence"] > 0).all() and df["pred"].between(0, 2).all()
    # cli.export, then cli.predict --artifact: the same predictions, and
    # confidences bit for bit (the artifact runs the Predictor's function)
    from missm_tpu_torch.cli.export import main as export_main

    export_main(argv + ["--split", "test", "--output", "artifact"])
    manifest = json.load(open("artifact/manifest.json"))
    assert manifest["format"] == "torch.export/pt2"
    assert manifest["batch_size"] == 8 and manifest["device"] == "cpu"
    assert manifest["op_namespace"] == "missm"
    assert os.path.getsize("artifact/model.pt2") == manifest["artifact_bytes"]
    served = predict_main(argv + ["--split", "test", "--output", "art.csv",
                                  "--artifact", "artifact"])
    pd.testing.assert_frame_equal(served, out)
    pd.testing.assert_frame_equal(pd.read_csv("art.csv"), df)


def test_cli_train_from_converted_checkpoint(workspace):
    """Convert -> train in one command from the fixture checkpoint."""
    from missm_tpu_torch.cli.train import main as train_main

    argv = _train_argv(workspace)
    argv[argv.index("random")] = "checkpoint"
    best, hist = train_main(argv + ["--checkpoint_dir", FIX])
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])


def test_resume_auto_recovers_from_old_dir(workspace):
    """A crash between _write's two renames leaves only last.old: --resume
    auto resumes from it (zero epochs left to train here) and rewrites
    nothing, where a fresh start would retrain and remove the .old."""
    from missm_tpu_torch.cli.train import main as train_main

    argv = _train_argv(workspace, "sum", "--num_epochs", "2",
                       "--checkpoint_every", "1")
    train_main(argv)
    last = "./experiments/mvsa_sum/checkpoints/last"
    assert os.path.isdir(last)
    os.rename(last, last + ".old")
    best, hist = train_main(argv + ["--resume", "auto"])
    assert [h["epoch"] for h in hist] == [0, 1]
    assert not os.path.isdir(last) and os.path.isdir(last + ".old")


def test_preempted_cli_exits_75(workspace, monkeypatch):
    """A SIGTERM during training lands the resume checkpoint and exits with
    EX_TEMPFAIL (75); --resume auto then finishes the run."""
    from missm_tpu_torch.cli import train as cli_train
    from missm_tpu_torch.train import loop

    real = loop.train_loop

    def preempted(*a, **kw):
        import signal

        class Loader:
            def __init__(self, inner):
                self.inner, self.batch_size = inner, inner.batch_size

            def __iter__(self):
                for i, b in enumerate(self.inner):
                    if i == 1:
                        signal.raise_signal(signal.SIGTERM)
                    yield b
        return real(a[0], a[1], Loader(a[2]), *a[3:], **kw)

    argv = _train_argv(workspace, "sum", "--num_epochs", "2")
    monkeypatch.setattr(cli_train, "train_loop", preempted)
    with pytest.raises(SystemExit) as e:
        cli_train.main(argv)
    assert e.value.code == 75
    from missm_tpu_torch.train.checkpoint import read_metadata
    meta = read_metadata("./experiments/mvsa_sum/checkpoints/last")
    # the signal is raised in the prefetch thread; the loop stops at the
    # first batch boundary after it
    assert meta["preempted"]["epoch"] == 0
    assert meta["preempted"]["batches_done"] >= 1
    monkeypatch.setattr(cli_train, "train_loop", real)
    best, hist = cli_train.main(argv + ["--resume", "auto"])
    assert [h["epoch"] for h in hist] == [0, 1]


def test_entry_points_default_to_the_card(workspace, monkeypatch):
    from missm_tpu_torch.cli.train import main as train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _train_argv(workspace)
    i = argv.index("--device")
    del argv[i:i + 2]
    assert train_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        train_main(argv)


# ---------------------------------------------------------------------------
# cli.test against the JAX package's
# ---------------------------------------------------------------------------

def test_cli_test_reports_equal_jax(tmp_path, monkeypatch):
    from missm_tpu.cli.test import main as jax_test_main
    from missm_tpu.core.config import tiny_tower as jax_tiny_tower
    from missm_tpu.models import finetune as jft
    from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
    from missm_tpu.train.checkpoint import save_checkpoint as jax_save
    from missm_tpu_torch.cli.test import main as test_main
    from missm_tpu_torch.compat.from_jax import from_jax
    from missm_tpu_torch.train.checkpoint import save_checkpoint

    csv = make_mvsa_tree(str(tmp_path / "mvsa"), write_media=True)
    jcfg = jft.ModelConfig(
        towers=(("image", jax_tiny_tower("image")),),
        fusion=JaxFusionConfig(fusion_type="sum",
                               modality_types=("language", "image"),
                               output_dims=3, feature_dims=24, fusion_dim=256))
    tree = jax.tree_util.tree_map(
        np.asarray, jft.init_model_params(jax.random.PRNGKey(5), jcfg))
    reports = {}
    for name in ("jax", "port"):
        run = tmp_path / name
        (run / "final_model").mkdir(parents=True)
        monkeypatch.chdir(run)
        argv = _test_argv(csv, "--bf16", "false", "--num_workers", "0")
        if name == "jax":
            jax_save("final_model/mvsa_sum", {"params": tree})
            i = argv.index("--device")
            jax_test_main(argv[:i] + argv[i + 2:])
        else:
            save_checkpoint("final_model/mvsa_sum",
                            {"params": from_jax(tree, device="cpu")})
            test_main(argv)
        reports[name] = {mt: (run / "new_txt_experiment" /
                              f"mvsa_sum_{mt}.txt").read_text()
                         for mt in ("language", "image", "mixed")}
    num = re.compile(r"-?\d+\.\d+$")
    for mt, want in reports["jax"].items():
        got = reports["port"][mt].splitlines()
        want = want.splitlines()
        assert len(got) == len(want) == 10 * 7
        for g, w in zip(got, want):
            if w.startswith("Test Accuracy"):
                assert g == w
            elif num.search(w) and not w.startswith("Testing"):
                assert g.rsplit(": ", 1)[0] == w.rsplit(": ", 1)[0]
                assert abs(float(g.rsplit(": ", 1)[1])
                           - float(w.rsplit(": ", 1)[1])) <= REPORT_ATOL, \
                    (mt, g, w)
            else:
                assert g == w


# ---------------------------------------------------------------------------
# Flags and the YAML layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["train", "test"])
def test_flags_and_defaults_equal_jax(which):
    from missm_tpu.compat import args as jargs

    got = vars((train_args if which == "train" else test_args)([]))
    want = vars((jargs.train_args if which == "train"
                 else jargs.test_args)([]))
    assert got.pop("device") == "cuda"
    assert want.pop("device", "tpu") == "tpu"
    assert got == want


UNPORTED = [
    (["--mesh_model", "2"], "queue 1 item 9"),
    (["--fsdp"], "queue 1 item 9"),
    (["--mesh_pipe", "2"], "queue 1 item 9"),
    (["--pipe_microbatches", "4"], "queue 1 item 9"),
    (["--pipe_schedule", "1f1b"], "queue 1 item 9"),
    (["--distributed", "true"], "queue 1 item 9"),
    (["--distributed", "10.0.0.1:1234,2,0"], "queue 1 item 9"),
    (["--uint8_upload", "true"], "no quantized host upload"),
]
# the named remat policies: each parses, in one value or a per-tower spec
POLICIES = [(["--remat", "save_attn_mlp"], "save_attn_mlp"),
            (["--remat", "image=save_most,default=true"],
             (("image", "save_most"), ("default", True)))]


@pytest.mark.parametrize("which", ["train", "test"])
@pytest.mark.parametrize("flags,item", UNPORTED,
                         ids=[" ".join(f) for f, _ in UNPORTED])
def test_unported_flags_raise(which, flags, item, capsys):
    parse = train_args if which == "train" else test_args
    with pytest.raises(SystemExit) as e:
        parse(flags + ["--modality_types", "language", "image"])
    assert e.value.code == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("which", ["train", "test"])
@pytest.mark.parametrize("flags,remat", POLICIES,
                         ids=[" ".join(f) for f, _ in POLICIES])
def test_remat_policies_parse(which, flags, remat):
    parse = train_args if which == "train" else test_args
    args = parse(flags + ["--modality_types", "language", "image"])
    assert args.remat == remat


def test_ported_flags_parse():
    args = train_args(["--remat", "false", "--grad_accum", "2",
                       "--batch_size", "4", "--checkpoint_every", "2",
                       "--resume", "auto", "--profile_dir", "p", "--bf16",
                       "false", "--distributed", "false", "--mesh_model", "1"])
    assert (args.remat, args.grad_accum, args.checkpoint_every, args.resume,
            args.bf16, args.distributed) == (False, 2, 2, "auto", False,
                                             False)
    args = train_args(["--remat", "image=false,default=true"])
    assert dict(args.remat) == {"image": False, "default": True}
    for bad in (["--grad_accum", "3", "--batch_size", "4"],
                ["--checkpoint_every", "-1"],
                ["--remat", "adio=true"]):
        with pytest.raises(SystemExit):
            train_args(bad)


def test_yaml_applies_and_cli_wins(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(
        "dataset:\n  name: AVE\n  csv_path: /d/ave/label.csv\n"
        "training:\n  epochs: 7\n  learning_rate: 0.005\n"
        "model:\n  fusion_type: concat\n  fusion_dim: 128\n")
    args = train_args(["--config", str(cfg), "--learning_rate", "0.001"])
    assert (args.datasetName, args.csv_path, args.num_epochs,
            args.fusion_type, args.fusion_dim) == \
        ("AVE", "/d/ave/label.csv", 7, "concat", 128)
    assert args.learning_rate == 0.001  # CLI beats YAML


def test_yaml_unknown_key_raises(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("model:\n  fusion_typo: sum\n")
    with pytest.raises(KeyError, match="fusion_typo"):
        train_args(["--config", str(cfg)])


def test_yaml_values_route_through_flag_parsers(tmp_path, capsys):
    good = tmp_path / "good.yaml"
    good.write_text("remat: video=false,default=true\n"
                    "dataset:\n  name: AVE\n  csv_path: /d/l.csv\n"
                    "  modality_types: [language, video, audio]\n")
    args = train_args(["--config", str(good)])
    assert dict(args.remat) == {"video": False, "default": True}

    typo = tmp_path / "typo.yaml"
    typo.write_text("remat: video=save_atn_mlp\n")
    with pytest.raises(argparse.ArgumentTypeError):
        train_args(["--config", str(typo)])

    policy = tmp_path / "policy.yaml"
    policy.write_text("remat: save_attn_mlp\n")
    assert train_args(["--config", str(policy)]).remat == "save_attn_mlp"

    badkey = tmp_path / "badkey.yaml"
    badkey.write_text("remat: adio=true\n"
                      "dataset:\n  modality_types: [language, audio]\n")
    with pytest.raises(SystemExit):
        train_args(["--config", str(badkey)])


def test_config_without_pyyaml_names_the_package(tmp_path, monkeypatch):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("training:\n  epochs: 7\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        train_args(["--config", str(cfg)])
