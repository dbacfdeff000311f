"""The plain reference against the port's plain path, at a tiny size on
the CPU in float32: the forward's logits, and one train step (the loss, the
first gradient by leaf, every leaf after Adam)."""
import numpy as np
import pytest
import torch

from conftest import tiny_config, tiny_mix
from portbench import harness, inputs
from portbench.reference import languagebind as ref
from portbench.reference.weights import make_params, paths_of, trainable

CELLS = [("lb-image-text", "mvsa-train-b64"),
         ("lb-video-audio-text", "sims-train-b16")]


def _setup(name, mixname, seed=7):
    cfg = tiny_config(name)
    cfg["compute_dtype"] = "float32"
    model = harness.family(cfg, "port")
    mix = tiny_mix(mixname)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    B = mix["batch"]
    data = {"language": model.text(cfg, B, rng, mix["text_lengths"])}
    data.update(model.media(cfg, B, gen))
    labels = inputs.labels(B, cfg["fusion"]["output_dims"], rng)
    codes = inputs.train_codes(B, mix["codes"], rng)
    return cfg, model.model_config(cfg), data, labels, codes


@pytest.mark.parametrize("name,mixname", CELLS)
def test_forward(name, mixname):
    from missm_tpu_torch.models.finetune import model_forward
    cfg, mcfg, data, labels, codes = _setup(name, mixname)
    params = make_params(cfg, 3, "cpu")
    with torch.no_grad():
        port_logits, _ = model_forward(params, mcfg, data, codes,
                                       device="cpu")
    ours = ref.eval_logits(ref.Model(cfg), params, ref.to_device(data, "cpu"),
                           torch.as_tensor(codes), 3)
    torch.testing.assert_close(port_logits, ours, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,mixname", CELLS)
def test_train_step(name, mixname):
    from missm_tpu_torch.train.step import init_train_state, make_train_step
    cfg, mcfg, data, labels, codes = _setup(name, mixname)
    params = make_params(cfg, 3, "cpu")
    state, tx = init_train_state(params, mcfg)
    step = make_train_step(mcfg, tx, device="cpu")
    gen = torch.Generator().manual_seed(11)
    state, out = step(state, data, labels, codes, 1e-3, gen)
    named = paths_of(params)
    grads = [float(tx.state[leaf]["exp_avg"].norm()) / 0.1
             for path, leaf in named if trainable(path)]

    start = make_params(cfg, 3, "cpu")
    keep = 1.0 - cfg["fusion"]["dropout_prob"]
    mask = next(ref.seeded_dropout(11, (len(labels), 8), keep, "cpu"))
    batch = (ref.to_device(data, "cpu"), torch.as_tensor(labels),
             torch.as_tensor(codes), mask)
    losses, first, after = ref.train_steps(ref.Model(cfg), start, [batch],
                                           1e-3, 3)
    first = [float(g.norm()) for g in first]
    assert float(out["loss"]) == pytest.approx(losses[0], rel=1e-5)
    np.testing.assert_allclose(grads, first, rtol=1e-4, atol=1e-7)
    # Adam's first step moves an element by lr g / (|g| + eps): where |g|
    # nears eps, the f32 rounding of g moves it by a visible part of lr; a
    # leaf whose gradient is nought to rounding (a key bias under softmax)
    # moves by round-off alone, so it is left out by the check's rule
    med = np.median(first)
    moved = iter(g >= 1e-3 * med for g in first)
    for (path, leaf), (_, mine) in zip(named, paths_of(start)):
        if trainable(path):
            assert path in after
            if not next(moved):
                # at most one step of lr an element, on both sides
                torch.testing.assert_close(leaf.detach(), mine, rtol=0,
                                           atol=2.001e-3)
                continue
        torch.testing.assert_close(leaf.detach(), mine, rtol=0, atol=5e-5)
