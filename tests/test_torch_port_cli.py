"""The port's data preparation, grid configs, ``train_driver`` and CLI held
against the JAX package (CPU).

The data prep runs on the committed SLBP trajectory of ``demo_artifacts``
and must match bit for bit; train_driver's split, dedup and best-config choice
must match on the same records; the CLI trains tiny NsDiff and TMDM models
on that trajectory and JAX loads what it wrote.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from upgdm_tpu.cli import train_driver as jdrv
from upgdm_tpu.models.nsdiff import NsDiffModel as JNsDiff
from upgdm_tpu.models.tmdm import TMDMModel as JTMDM
from upgdm_tpu.utils import config as jcfg
from upgdm_tpu.utils import data_prep as jprep
from upgdm_tpu.utils import io as jio
from upgdm_tpu_torch.cli import train_driver as drv
from upgdm_tpu_torch.cli import train_timeseries
from upgdm_tpu_torch.utils import config as cfg
from upgdm_tpu_torch.utils import data_prep as prep
from upgdm_tpu_torch.utils import io as pio
from test_torch_port_train import jax_model

REPO = Path(__file__).resolve().parents[1]
SLBP = REPO / "demo_artifacts/slbp_data"


def test_unfold_windows_and_decimation_match_jax():
    x = np.random.default_rng(0).normal(size=(3, 50, 2)).astype(np.float32)
    for axis, length, step in ((1, 7, 3), (0, 2, 1), (1, 50, 5)):
        np.testing.assert_array_equal(prep.unfold_windows(x, length, step, axis),
                                      jprep.unfold_windows(x, length, step, axis))
    with pytest.raises(ValueError, match="not enough"):
        prep.unfold_windows(x, 51, 1, axis=1)
    for st in (0.1, 0.5, 100):
        assert prep._decimation_interval(st) == jprep._decimation_interval(st)
    with pytest.raises(AssertionError):
        prep._decimation_interval(0.05)


@pytest.mark.parametrize("data_filter,name", [("*", "x_increase"), ("*_increase", "x_increase"),
                                              ("*_decrease", "x_increase")])
def test_flip_augment_matches_jax(data_filter, name):
    w = np.arange(12, dtype=np.float32).reshape(6, 2)
    got, want = (m.flip_augment(w, data_filter, name) for m in (prep, jprep))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(STG_exist=False, filter="*"),
    dict(STG_exist=True, filter="*"),
    dict(STG_exist=False, filter="*_increase"),
    dict(STG_exist=False, filter="*_decrease", interval_step=7),
    dict(STG_exist=True, filter="*", data_dropout=0.5),
], ids=["demo", "univariate", "increase", "decrease", "data_dropout"])
def test_pre_dataset_timeseries_bit_for_bit_on_slbp(kw):
    """The demo's own parameters first (examples/slbp_demo.py:75-78)."""
    param = dict(file_path=str(SLBP), sampling_t=100, windows=100, pred_len=100,
                 interval_step=20)
    param.update(kw)
    got = prep.pre_dataset_timeseries(**param)
    want = jprep.pre_dataset_timeseries(**param)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if kw == dict(STG_exist=False, filter="*"):
        assert got.shape == (182, 200, 2)


def test_pre_dataset_timeseries_real_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for name in ("a", "b"):
        for i in range(2):
            pio.save_pt({"ys_dynamic": rng.normal(size=(300, 2)).astype(np.float32),
                         "ts_dynamic": np.arange(300, dtype=np.float32)},
                        tmp_path / name / "pt" / f"rec{i}.pt")
    for filt in ("*", "a"):
        param = dict(file_path=str(tmp_path), windows=20, pred_len=10, interval_step=15,
                     sampling_t=0.2, filter=filt, data_dropout=0.7)
        got = prep.pre_dataset_timeseries_real(**param)
        np.testing.assert_array_equal(got, jprep.pre_dataset_timeseries_real(**param))
        assert got.shape[1:] == (30, 1)
    empty = prep.pre_dataset_timeseries_real(str(tmp_path), 20, 10, 15, 0.2, filter="none")
    assert empty.shape == (0, 30, 1)


@pytest.mark.parametrize("family", ["NsDiff", "TMDM"])
def test_grid_expansion_matches_jax(family):
    c = cfg.load_grid_config(REPO / f"configs/grid_search/diffusion_model_{family}.yaml")
    sections = [c[k] for k in ("train", "net", "loss", "optimizer")]
    got, got_hp = cfg.grid_parameters_generative_learning(*sections)
    want, want_hp = jcfg.grid_parameters_generative_learning(*sections)
    assert got == want and got_hp == want_hp and len(got) >= 1


def test_split_and_best_config_match_jax():
    for n, size, seed in ((182, 0.9, 0), (10, 0.5, 3)):
        for a, b in zip(drv._split_train_val(n, size, seed), jdrv._split_train_val(n, size, seed)):
            np.testing.assert_array_equal(a, b)
    records = {
        "config_0": {"train_scores": [3.0, 2.0, 1.5], "val_scores": [2.5, 2.2, 2.4]},
        "config_1": {"train_scores": [2.0, 1.0, 0.5], "val_scores": [2.6, 2.3, 2.1]},
        "config_2": {"train_scores": [1.0], "val_scores": []},
    }
    assert drv._select_best(records) == jdrv._select_best(records)
    assert drv._select_best(records)[1] == ("config_1", 2.1)


def test_save_config_dedup_matches_jax(tmp_path):
    kw = dict(dataset_param={"windows": 4}, net_param={"d_model": 8}, train_param={"e": 1},
              optimizer_param={"lr": 1e-3}, loss_param={})
    for side, mod in (("port", pio), ("jax", jio)):
        d = tmp_path / side
        assert mod.save_config_dedup(d, "c.yaml", **kw) == (True, None)
        assert mod.save_config_dedup(d, "c.yaml", **kw) == (True, None)  # not trained yet
        (d / "hold_out/trained_model").mkdir(parents=True)
        mod.save_record(d / "hold_out/train_trace/record_scores.json", {"epoch": [0]})
        assert mod.save_config_dedup(d, "c.yaml", **kw) == (False, {"epoch": [0]})
        assert mod.save_config_dedup(d, "c.yaml", **dict(kw, loss_param={"x": 1}))[0]
    assert (tmp_path / "port/c.yaml").read_text() == (tmp_path / "jax/c.yaml").read_text()


NET = {
    "NsDiff": dict(task_model=["NsDiff"], scaler_type=["StandardScaler"], rolling_length=[4],
                   diffusion_steps=[4], d_model=[16], n_heads=[2], e_layers=[1], d_layers=[1],
                   d_ff=[16], p_hidden_dims=[[8, 8]], p_hidden_layers=[2], n_z_samples=[2],
                   dropout=[0.05]),
    "TMDM": dict(task_model=["TMDM"], scaler_type=["StandardScaler"], diffusion_steps=[4],
                 d_model=[16], n_heads=[2], e_layers=[1], d_layers=[1], d_ff=[16],
                 p_hidden_dims=[[8, 8]], p_hidden_layers=[2], n_z_samples=[2], dropout=[0.05]),
}


def _cli_config(tmp_path, family, mode, lrs=(1e-3,)):
    c = {
        "out_dir": str(tmp_path / "out"),
        "dataset": dict(file_path=[str(SLBP)], filter=["*"], sampling_t=[100], windows=[16],
                        pred_len=[8], interval_step=[200], STG_exist=[False]),
        "train": dict(model_evaluation=[mode], train_model_select=["NsDiff_model"],
                      traindata_size=[0.75], train_batch_size=[8], val_batch_size=[8],
                      train_epochs=[2], test_set=[True], ckpt=[False], ckpt_period=[10],
                      n_splits=[2]),
        "net": NET[family],
        "loss": dict(loss_metric=["KL divergence"]),
        "optimizer": dict(optimizer_name=["Adam"], lr=list(lrs), weight_decay=["1e-5"],
                          scheduler_set=[False]),
    }
    path = tmp_path / f"{family}_{mode}.yaml"
    path.write_text(yaml.safe_dump(c))
    return path


@pytest.mark.parametrize("family,jcls", [("NsDiff", JNsDiff), ("TMDM", JTMDM)])
def test_cli_hold_out_trains_and_jax_loads_the_result(tmp_path, family, jcls):
    train_timeseries.main(["--cfg", str(_cli_config(tmp_path, family, "hold_out")),
                           "--train_mode", "hold_out", "--device", "cpu"])
    run = tmp_path / "out/hold_out"
    rs = pio.load_record(run / "train_trace/record_scores.json")
    assert rs["epoch"] == [0, 1] and all(np.isfinite(rs["train_scores"] + rs["val_scores"]))
    net_param, sd = jio.load_checkpoint(run / "trained_model/model_trained")
    assert net_param["windows"] == 16 and net_param["dataset_nf"] == 2
    jax_model(jcls, net_param).load_state_dict(sd, strict=True)
    conf = pio.read_model_config(run / "trained_model")
    assert conf["dataset"]["windows"] == 16 and conf["optimizer"]["lr"] == 1e-3


def test_cli_cross_val_and_grid_pick_the_jax_best(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    train_timeseries.main(["--cfg", str(_cli_config(tmp_path, "NsDiff", "cross_val")),
                           "--train_mode", "cross_val", "--device", "cpu"])
    avg = pio.load_record(tmp_path / "out/cross_val/average_scores.json")
    assert avg["epoch"] == [0, 1] and len(avg["val_scores"]) == 2
    assert (tmp_path / "out/cross_val/random_1/trained_model/model_trained").exists()

    grid_cfg = _cli_config(tmp_path, "NsDiff", "hold_out", lrs=(1e-3, 1e-2))
    args = ["--cfg", str(grid_cfg), "--train_mode", "grid", "--device", "cpu"]
    train_timeseries.main(args)
    gs = tmp_path / "out/dataset__w16p8st100/grid_search"
    records = json.loads((gs / "configs_record_scores.json").read_text())
    assert sorted(records) == ["config_0", "config_1"]
    stats, best = jdrv._select_best(records)
    assert json.loads((gs / "all_models_record_statistic.json").read_text()) == stats
    assert f"best config: {best[0]}" in capsys.readouterr().out
    hp = yaml.safe_load((tmp_path / "HP_analysis_result/out/dataset__w16p8st100/"
                         "hyperparameters.yaml").read_text())
    assert hp == {"optimizer": {"lr": [1e-3, 1e-2]}}
    # a second grid run finds both configs trained and trains nothing
    model_file = gs / "config_0/hold_out/trained_model/model_trained"
    stamp = model_file.stat().st_mtime_ns
    train_timeseries.main(args)
    assert model_file.stat().st_mtime_ns == stamp
    assert json.loads((gs / "configs_record_scores.json").read_text()) == records


def test_cli_trains_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_timeseries.main(["--cfg", str(_cli_config(tmp_path, "NsDiff", "hold_out")),
                               "--train_mode", "hold_out"])
    args = train_timeseries.parse_args([])
    assert args.train_mode == "grid" and args.device is None and not args.real
    with pytest.raises(NotImplementedError):
        drv.grid_search({}, {}, {}, {}, {}, tmp_path, None, spdata=True)
