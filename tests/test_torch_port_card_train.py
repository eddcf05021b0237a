"""Training with the port on the card.

The train step of every NsDiff stage at the train-bench geometry
(``bench_train.py``: B 64, W/P 100/100, d_model 512, e4/d2) and of TMDM at its
model-comparison geometry, in float32 and ``train_dtype="bfloat16"``; the
card's loss and gradients against the port's CPU run on one batch; the demo's
three-stage protocol (``examples/slbp_demo.py``) on the committed SLBP
trajectory through ``run_training``, each stage's score against the committed
JAX record; a seeded stage run twice with equal records; and the checkpoint
it wrote swept through K1. The train step as a CUDA graph against the eager
step is in ``test_torch_port_train_graph.py``. Every case skips without a CUDA
device; on the card (see ``card_checks.py``):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_card_train.py -m card
"""
import json

import numpy as np
import pytest
import torch

from card_checks import (
    DEMO, PRED_LEN, STEPS, T_LABEL, T_STEPS, TMDM_TRAIN_PARAM, TRAIN_B, TRAIN_PARAM, WINDOWS,
    assert_updates, card, card_vs_cpu, counts, demo_split, train_losses,  # noqa: F401
    zero_counts,
)

# the demo's protocol (examples/slbp_demo.py:69-130): each stage's mean train
# score over its last 3 epochs within 25% of the committed JAX record's
DEMO_EPOCHS, DEMO_BAR = 30, 0.25
DEMO_STAGES = (("pretrain_f", "pre_model_F"), ("pretrain_g", "pre_model_G"),
               ("NsDiff_model", "nsdiff"))


def train_draws():
    """(batch [64, W+P, 1] on the card, NsDiff's and TMDM's timestep and
    noise seams for 16 rows) from default_rng(0)."""
    rng = np.random.default_rng(0)
    batch = torch.as_tensor(rng.normal(size=(TRAIN_B, WINDOWS + PRED_LEN, 1)),
                            dtype=torch.float32, device="cuda")
    seams_ns = dict(t=torch.arange(16) % STEPS,
                    noise=torch.as_tensor(rng.normal(size=(16, PRED_LEN, 1)), dtype=torch.float32))
    seams_tm = dict(t=torch.arange(16) * 6 % T_STEPS,
                    noise=torch.as_tensor(rng.normal(size=(16, T_LABEL + PRED_LEN, 1)),
                                          dtype=torch.float32))
    return batch, seams_ns, seams_tm


@pytest.mark.card
@pytest.mark.parametrize("name", ("pretrain_f", "pretrain_g", "NsDiff_model", "TMDM"))
def test_train_steps_float32_then_bf16(card, name):
    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.models.tmdm import TMDMModel

    select = name if name.startswith("pretrain") else None
    if name == "TMDM":
        model = TMDMModel(TMDM_TRAIN_PARAM, seed=0, device="cuda")
    elif select:
        model = NsDiffModel(TRAIN_PARAM, select, seed=0, device="cuda")
    else:
        model = NsDiffModel(TRAIN_PARAM, seed=0, device="cuda")
    batch = train_draws()[0]
    for dt in ("float32", "bfloat16"):  # the bf16 steps go on from the float32 ones
        losses = train_losses(model, select, batch, dt)
        assert np.isfinite(losses).all(), f"{name} {dt}: losses {losses}"


@pytest.mark.card
@pytest.mark.parametrize("name", ("NsDiff_model", "TMDM"))
def test_train_card_against_cpu(card, name):
    """Loss and gradients on one batch of 16 at the same widths, dropout off."""
    from upgdm_tpu_torch.models.nsdiff import NsDiffModel
    from upgdm_tpu_torch.models.tmdm import TMDMModel

    batch, seams_ns, seams_tm = train_draws()
    cls, param, seams = ((NsDiffModel, dict(TRAIN_PARAM, dropout=0.0), seams_ns)
                         if name == "NsDiff_model"
                         else (TMDMModel, dict(TMDM_TRAIN_PARAM, dropout=0.0), seams_tm))
    card_vs_cpu(cls(param, seed=1, device="cuda"), cls, param, batch[:16], seams)


@pytest.fixture(scope="module")
def demo(card, tmp_path_factory):
    """The demo's three stages through ``run_training`` on the card
    (NsDiff_model: g from its stage, f from scratch), each stage's model
    copied to ``<stage dir>/model_trained``; then pretrain_f once more."""
    from upgdm_tpu_torch.train.loop import run_training
    from upgdm_tpu_torch.utils.io import read_model_config

    tmp = tmp_path_factory.mktemp("demo")
    tr, va, dataset_param = demo_split()
    net = dict(read_model_config(DEMO / "pre_model_F/trained_model")["net"],
               load_pretrain=False)
    opt = dict(optimizer_name="Adam", lr=1e-3, weight_decay=1e-5, scheduler_set=False)
    base = dict(train_batch_size=32, val_batch_size=len(va), test_set=True, ckpt=False,
                ckpt_period=10, train_epochs=DEMO_EPOCHS)

    def stage(select, out, stage_net):
        return run_training(tr, va, dict(base, train_model_select=select), dict(stage_net),
                            {"loss_metric": "KL divergence"}, opt, out,
                            dataset_param=dataset_param, device="cuda")

    records = {}
    for select, ref in DEMO_STAGES:
        out = tmp / ref
        stage_net = net
        if select == "NsDiff_model":
            stage_net = dict(net, load_pretrain=True, pretrain_f_path=str(tmp / "pre_model_F"),
                             pretrain_g_path=str(tmp / "pre_model_G"))
        records[select] = stage(select, out, stage_net)
        (out / "model_trained").write_bytes((out / "trained_model/model_trained").read_bytes())
    again = stage("pretrain_f", tmp / "pre_model_F_again", net)
    return tmp, records, again


@pytest.mark.card
@pytest.mark.parametrize("select, ref", DEMO_STAGES)
def test_demo_stage_against_the_jax_record(demo, select, ref):
    rs = demo[1][select]
    jax_rs = json.loads((DEMO / ref / "train_trace/record_scores.json").read_text())
    got, want = (float(np.mean(rs["train_scores"][-3:])),
                 float(np.mean(jax_rs["train_scores"][-3:])))
    assert abs(got / want - 1.0) <= DEMO_BAR, (
        f"{select}: last-3-epoch train score {got} vs the JAX record's {want}")


@pytest.mark.card
def test_seeded_training_repeats(demo):
    _, records, again = demo
    assert again == records["pretrain_f"], "two seeded pretrain_f runs gave other records"


@pytest.mark.card
def test_trained_checkpoint_sweeps_through_k1(demo):
    from upgdm_tpu_torch.eval.uncertainty import (
        fast_mpv_sweep, load_dynamic_data, load_model_from_dir,
    )
    from upgdm_tpu_torch.ops.windows import sample_time_series, sliding_windows
    from upgdm_tpu_torch.utils.io import read_model_config

    tmp = demo[0]
    trained, _ = load_model_from_dir(tmp / "nsdiff/trained_model", device="cuda")
    cfg = read_model_config(tmp / "nsdiff/trained_model")
    slbp = load_dynamic_data(next((DEMO / "slbp_data").rglob("*.pt")), dynamic_type="SLBP")
    series, tdata = sample_time_series(slbp["torch_time_series"], slbp["time_data"],
                                       cfg["dataset"]["sampling_t"])
    slbp_w, _ = sliding_windows(series, tdata, cfg["dataset"]["windows"], 200)
    zero_counts()
    demo_mpv, _ = fast_mpv_sweep(trained, slbp_w, cfg["dataset"]["pred_len"], chunk_windows=4)
    k1 = counts()[0]
    assert_updates("the sweep", k1)
    n_steps = trained.diffusion_steps * -(-len(slbp_w) // 4)
    assert k1 == n_steps, f"K1 launched {k1} times, expected {n_steps}"
    assert (demo_mpv.shape == (len(slbp_w),) and np.isfinite(demo_mpv).all()
            and (demo_mpv > 0).all()), f"bad MPV {demo_mpv}"
