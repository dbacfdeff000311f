"""The slice as a whole: a mvsa tree on disk through each package's
`testing_loader` and production media loaders (PIL decode, the device
image transform, the tokenizer) into `run_missing_sweep(concat_mean)`.

JAX: missm_tpu.data.loaders.testing_loader + missm_tpu.data.preprocess.
make_media_loaders + missm_tpu.eval.sweep.run_missing_sweep (the chain of
missm_tpu/cli/test.py:29-54). Port: the same names under missm_tpu_torch,
on the CPU. A tiny image+text model with the concat head, params
initialised in JAX and bridged with `from_jax`, f32.

Tolerances, set before the run: accuracy and F1 exact (the predictions
agree); the loss 1e-5 relative; AUC 1e-6 absolute (the probabilities agree
to about 1e-6, far from any tie that would reorder them); the reports line
for line, every non-numeric line identical and every number within 1e-4
(one unit in the 4th decimal), as tests/test_torch_sweep.py holds the
sweep on arrays in memory.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.data import loaders as jloaders
from missm_tpu.data import preprocess as jpre
from missm_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from missm_tpu.eval import sweep as jsweep
from missm_tpu.models import finetune as jft
from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
from missm_tpu.train.step import make_eval_step as jax_make_eval_step
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.data import loaders as tloaders
from missm_tpu_torch.data import preprocess as tpre
from missm_tpu_torch.data.tokenizer import HashTokenizer
from missm_tpu_torch.eval import sweep as tsweep
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.train.step import make_eval_step
from tests.synthetic import Args, make_mvsa_tree

FUSION = dict(fusion_type="concat", modality_types=("language", "image"),
              output_dims=3, feature_dims=24, fusion_dim=8)
LOSS_RTOL = 1e-5
AUC_ATOL = 1e-6
REPORT_ATOL = 1e-4
NUMBER = re.compile(r"-?\d+\.\d+")


def test_sweep_from_disk_matches_jax(tmp_path):
    csv = make_mvsa_tree(str(tmp_path / "mvsa"), n_train=12, n_valid=2,
                         n_test=11, write_media=True)
    args = Args(batch_size=4, num_workers=2)
    jcfg = jft.ModelConfig(towers=(("image", jax_tiny_tower("image")),),
                           fusion=JaxFusionConfig(**FUSION))
    tcfg = tft.ModelConfig(towers=(("image", tiny_tower("image")),),
                           fusion=FusionConfig(**FUSION))
    tree = jax.tree_util.tree_map(
        np.asarray, jft.init_model_params(jax.random.PRNGKey(0), jcfg))

    # the tokenizer as missm_tpu/cli/common.py:120-133 sets it up
    text = tcfg.towers[0][1].text
    tok_t = HashTokenizer(text.vocab_size, text.max_position_embeddings)
    tok_j = JaxHashTokenizer(text.vocab_size, text.max_position_embeddings)
    t_train, t_test, _ = tloaders.testing_loader(
        args, csv, tok_t, tpre.make_media_loaders(tcfg.tower_dict,
                                                  device="cpu"))
    j_train, j_test, _ = jloaders.testing_loader(
        args, csv, tok_j, jpre.make_media_loaders(jcfg.tower_dict))
    assert sum(len(per) for per in t_test.values()) == 30

    got = tsweep.run_missing_sweep(
        from_jax(tree, device="cpu"), tcfg, make_eval_step(tcfg,
                                                           device="cpu"),
        t_test, str(tmp_path / "t"), "mvsa", "concat_mean",
        train_loader=t_train, verbose=False, device="cpu")
    want = jsweep.run_missing_sweep(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
        jax_make_eval_step(jcfg), j_test, str(tmp_path / "j"), "mvsa",
        "concat_mean", train_loader=j_train, verbose=False)

    for mt in want:
        assert list(got[mt]) == list(want[mt])
        for r in want[mt]:
            g, w = got[mt][r], want[mt][r]
            assert g["accuracy"] == w["accuracy"], (mt, r)
            assert g["f1"] == w["f1"], (mt, r)
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(g["auc"], w["auc"], rtol=0,
                                       atol=AUC_ATOL)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names == [
        f"mvsa_concat_mean_{m}.txt" for m in ("image", "language", "mixed")]
    for name in names:
        g = (tmp_path / "t" / name).read_text().splitlines()
        w = (tmp_path / "j" / name).read_text().splitlines()
        assert len(g) == len(w) == 10 * 7
        for a, b in zip(g, w):
            assert NUMBER.sub("#", a) == NUMBER.sub("#", b)
            np.testing.assert_allclose(
                [float(x) for x in NUMBER.findall(a)],
                [float(x) for x in NUMBER.findall(b)], rtol=0,
                atol=REPORT_ATOL, err_msg=a)

