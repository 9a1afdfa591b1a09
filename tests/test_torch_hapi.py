"""The port's `hapi.Model` against the JAX package's: LeNet from the same
weights fit on 256 synthetic MNIST samples for 2 shuffled epochs under
one numpy seed (every batch loss, the epoch metrics), then `evaluate`,
`predict`, the `*_batch` methods and `summary`; the callbacks
(EarlyStopping, ReduceLROnPlateau, LRScheduler against the JAX Model's
runs; ModelCheckpoint, ProgBarLogger and VisualDL by what they write);
`save`/`load`, `load_latest` and the JAX Model loading the port's
`.pdparams`; a fit stopped at step k and resumed through `load_latest`
and `fit(resume=True)`, bitwise equal to the run without a stop (port
only); the item-6 hooks refused.

Tolerances: losses within 1e-4 relative; metrics, evaluate's logs and
predict's outputs within 1e-5 x max(1, |ref|).
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu import io as jio
from paddle_tpu.vision.datasets import MNIST as JMNIST
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.vision.datasets import MNIST as TMNIST
from paddle_tpu_torch.vision.models import LeNet as TLeNet

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

LOSS_RTOL = 1e-4
OUT_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def near(got, want, rtol, what=""):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert (err <= rtol * np.maximum(1.0, np.abs(want))).all(), \
        (what, err.max())


@functools.lru_cache(maxsize=None)
def mnist(port, mode):
    """One package's synthetic MNIST split, built once per module (the
    data home points nowhere, so it is the synthetic set whatever the
    environment holds)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_DATA_HOME", os.devnull)
        return (TMNIST if port else JMNIST)(mode=mode)


def pair(n_train=256, n_test=64, lr=1e-3, metrics=True):
    """(port Model, JAX Model, port data, JAX data): LeNet with the JAX
    model's weights in both, Adam and cross entropy (and Accuracy)."""
    pj.seed(21)
    jnet = JLeNet()
    tnet = TLeNet()
    tnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in jnet.state_dict().items()})
    jm, tm = pj.Model(jnet), pt.Model(tnet)
    jm.prepare(pj.optimizer.Adam(learning_rate=lr,
                                 parameters=jnet.parameters()),
               pj.nn.CrossEntropyLoss(),
               pj.metric.Accuracy() if metrics else None)
    tm.prepare(pt.optimizer.Adam(learning_rate=lr,
                                 parameters=tnet.parameters()),
               pt.nn.CrossEntropyLoss(),
               pt.metric.Accuracy() if metrics else None)
    tdata = (tio.Subset(mnist(True, "train"), range(n_train)),
             tio.Subset(mnist(True, "test"), range(n_test)))
    jdata = (jio.Subset(mnist(False, "train"), range(n_train)),
             jio.Subset(mnist(False, "test"), range(n_test)))
    return tm, jm, tdata, jdata


class EpochLogs(tcb.Callback):
    def __init__(self):
        super().__init__()
        self.logs = []

    def on_epoch_end(self, epoch, logs=None):
        self.logs.append(dict(logs))


class JEpochLogs(pj.hapi.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.logs = []

    def on_epoch_end(self, epoch, logs=None):
        self.logs.append(dict(logs))


def test_fit_evaluate_predict_equal_jax():
    tm, jm, (ttr, tte), (jtr, jte) = pair()
    tlog, jlog = EpochLogs(), JEpochLogs()
    np.random.seed(3)
    th = tm.fit(ttr, batch_size=32, epochs=2, verbose=0, callbacks=[tlog])
    np.random.seed(3)
    jh = jm.fit(jtr, batch_size=32, epochs=2, verbose=0, callbacks=[jlog])
    assert len(th["loss"]) == len(jh["loss"]) == 16
    near(th["loss"], jh["loss"], LOSS_RTOL, "losses")
    assert len(th["data_wait_s"]) == 16
    assert all(w >= 0 for w in th["data_wait_s"])
    for t, j in zip(tlog.logs, jlog.logs):
        assert t.keys() == j.keys()
        near(t["acc"], j["acc"], OUT_RTOL, "epoch acc")
    te = tm.evaluate(tte, batch_size=16, verbose=0)
    je = jm.evaluate(jte, batch_size=16, verbose=0)
    assert te.keys() == je.keys() == {"loss", "acc"}
    for k in je:
        near(te[k], je[k], OUT_RTOL, f"evaluate {k}")
    tp = tm.predict(tte, batch_size=16, stack_outputs=True)
    jp = jm.predict(jte, batch_size=16, stack_outputs=True)
    assert len(tp) == len(jp) == 1
    near(tp[0], jp[0], OUT_RTOL, "predict")
    x, y = tte[0]
    xb = np.stack([x, tte[1][0]])
    yb = np.asarray([y, tte[1][1]]).reshape(2, 1)
    near(tm.predict_batch(xb)[0], jm.predict_batch(xb)[0], OUT_RTOL,
         "predict_batch")
    near(tm.eval_batch(xb, yb), jm.eval_batch(xb, yb), OUT_RTOL,
         "eval_batch")


def test_train_batch_equal_jax():
    tm, jm, (ttr, _), _ = pair(n_train=8, n_test=8, metrics=False)
    xb = np.stack([ttr[i][0] for i in range(4)])
    yb = np.asarray([ttr[i][1] for i in range(4)]).reshape(4, 1)
    for _ in range(2):
        near(tm.train_batch(xb, yb), jm.train_batch(xb, yb), LOSS_RTOL,
             "train_batch")


def test_summary_counts_equal_jax(capsys):
    want = pj.summary(JLeNet())
    got = pt.summary(TLeNet())
    assert got == want
    out = capsys.readouterr().out
    assert f"Total params: {want['total_params']:,}" in out
    assert pt.Model(TLeNet()).summary() == want


def test_lr_callbacks_and_early_stopping_equal_jax():
    """A StepDecay schedule stepped by LRScheduler, ReduceLROnPlateau and
    EarlyStopping on the loss, the JAX Model's runs beside the port's."""
    out = {}
    for P, M in ((pt, TLeNet), (pj, JLeNet)):
        pj.seed(21)
        ref = JLeNet()
        net = M()
        if P is pt:
            net.set_state_dict({k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
        else:
            net = ref
        io = tio if P is pt else jio
        ds = io.Subset(mnist(P is pt, "train"), range(64))
        sched = P.optimizer.lr.StepDecay(learning_rate=0.01, step_size=3,
                                         gamma=0.5)
        m = P.Model(net)
        m.prepare(P.optimizer.Adam(learning_rate=sched,
                                   parameters=net.parameters()),
                  P.nn.CrossEntropyLoss())
        lrs = []
        cbs = P.hapi.callbacks
        probe = type("Probe", (cbs.Callback,), {
            "on_train_batch_end":
                lambda self, step, logs=None: lrs.append(
                    m._optimizer.get_lr())})()
        np.random.seed(4)
        hist = m.fit(ds, batch_size=16, epochs=2, verbose=0,
                     callbacks=[cbs.LRScheduler(by_step=True), probe])
        # ReduceLROnPlateau on a fixed lr, then EarlyStopping
        m2 = P.Model(net)
        m2.prepare(P.optimizer.Adam(learning_rate=0.02,
                                    parameters=net.parameters()),
                   P.nn.CrossEntropyLoss())
        plateau = cbs.ReduceLROnPlateau(monitor="loss", factor=0.5,
                                        patience=1, min_delta=10.0,
                                        verbose=0)
        early = cbs.EarlyStopping(monitor="loss", patience=2,
                                  min_delta=10.0)
        np.random.seed(5)
        h2 = m2.fit(ds, batch_size=16, epochs=6, verbose=0,
                    callbacks=[plateau, early])
        out[P] = (lrs, hist["loss"], m2._optimizer.get_lr(),
                  len(h2["loss"]), m2.stop_training)
    t, j = out[pt], out[pj]
    near(t[0], j[0], 1e-12, "scheduled lr")
    near(t[1], j[1], LOSS_RTOL, "scheduled losses")
    assert t[2] == j[2] < 0.02
    assert t[3:] == j[3:] and t[4] is True


def test_checkpoint_progbar_and_visualdl(tmp_path, capsys):
    tm, _, (ttr, _), _ = pair(n_train=64, n_test=16)
    np.random.seed(6)
    tm.fit(ttr, batch_size=16, epochs=2, verbose=0,
           save_dir=str(tmp_path / "ckpt"),
           callbacks=[tcb.ProgBarLogger(log_freq=2, verbose=1),
                      tcb.VisualDL(str(tmp_path / "vdl"))])
    names = sorted(os.listdir(tmp_path / "ckpt"))
    for prefix in ("0", "1", "final"):
        for ext in (".pdparams", ".pdopt", ".pdtrain"):
            assert prefix + ext in names
    assert json.load(open(tmp_path / "ckpt" / "latest.json"))["path"] == \
        "final"
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == \
        ["step 0", "step 2", "Epoch 0", "step 0", "step 2", "Epoch 1"]
    rows = [json.loads(r) for r in
            open(tmp_path / "vdl" / "scalars.jsonl").read().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2, 3] * 2
    assert all({"loss", "acc", "batch_size"} <= r.keys() for r in rows)


def test_save_load_and_the_jax_model_reads_the_port(tmp_path):
    tm, jm, (ttr, tte), (_, jte) = pair(n_train=64, n_test=32)
    np.random.seed(7)
    tm.fit(ttr, batch_size=16, epochs=1, verbose=0)
    want = tm.evaluate(tte, batch_size=16, verbose=0)
    path = str(tmp_path / "m" / "lenet")
    tm.save(path)
    fresh = pt.Model(TLeNet())
    fresh.prepare(pt.optimizer.Adam(parameters=fresh.parameters()),
                  pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    fresh.load(path)
    assert fresh.evaluate(tte, batch_size=16, verbose=0) == want
    assert fresh._optimizer.state_dict()["global_step"] == 4
    latest = pt.Model(TLeNet())
    latest.prepare(pt.optimizer.Adam(parameters=latest.parameters()),
                   pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    assert latest.load_latest(str(tmp_path / "m")) == path
    assert latest.evaluate(tte, batch_size=16, verbose=0) == want
    # the JAX Model loads the port's .pdparams and evaluates the same
    jm.load(path, reset_optimizer=True)
    je = jm.evaluate(jte, batch_size=16, verbose=0)
    for k in want:
        near(je[k], want[k], OUT_RTOL, f"jax evaluate {k}")
    # a params-only save drops the stale optimizer and train-state files
    tm.save(path, training=False)
    assert not os.path.exists(path + ".pdopt")
    assert not os.path.exists(path + ".pdtrain")
    # a torn checkpoint is refused
    with open(path + ".pdparams", "ab") as f:
        f.write(b"torn")
    assert pt.Model(TLeNet()).load_latest(str(tmp_path / "m")) is None
    assert pt.Model(TLeNet()).load_latest(str(tmp_path / "none")) is None


def run_fit(save_dir=None, num_iters=None, resume_from=None):
    """The port's LeNet fit over 2 shuffled epochs of 64 samples (8
    steps), from one seed; `resume_from` loads the newest checkpoint
    there and resumes. Returns (model, history)."""
    pt.seed(31)
    np.random.seed(31)
    net = TLeNet()
    m = pt.Model(net)
    m.prepare(pt.optimizer.Adam(learning_rate=0.01,
                                parameters=net.parameters()),
              pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    ds = tio.Subset(mnist(True, "train"), range(64))
    if resume_from is not None:
        assert m.load_latest(resume_from) is not None
        return m, m.fit(ds, batch_size=16, epochs=2, verbose=0,
                        resume=True)
    return m, m.fit(ds, batch_size=16, epochs=2, verbose=0,
                    save_dir=save_dir, save_steps=1 if save_dir else None,
                    num_iters=num_iters)


@pytest.mark.parametrize("stop_at", [3, 6])
def test_resume_is_bitwise_equal_to_the_run_without_a_stop(tmp_path,
                                                           stop_at):
    full, h_full = run_fit()
    _, h_cut = run_fit(save_dir=str(tmp_path), num_iters=stop_at)
    assert h_cut["loss"] == h_full["loss"][:stop_at]
    assert sorted(os.listdir(tmp_path))[-1] == "step6.pdtrain" or \
        stop_at == 3
    resumed, h_res = run_fit(resume_from=str(tmp_path))
    assert h_res["loss"] == h_full["loss"][stop_at:]
    for (k, a), (_, b) in zip(full.network.state_dict().items(),
                              resumed.network.state_dict().items()):
        assert np.array_equal(a.numpy(), b.numpy()), k
    assert resumed._optimizer._global_step == 8


def test_item_6_hooks_are_refused():
    tm, _, (ttr, _), _ = pair(n_train=16, n_test=16)
    with pytest.raises(NotImplementedError, match="item 6"):
        tm.fit(ttr, batch_size=8, flight_recorder="journal.jsonl")
    with pytest.raises(NotImplementedError, match="item 6"):
        tm.fit(ttr, batch_size=8, watchdog=True)
    with pytest.raises(NotImplementedError, match="item 6"):
        tcb.TelemetryCallback()
    # watchdog=False is "off", as in the JAX package
    assert len(tm.fit(ttr, batch_size=8, watchdog=False)["loss"]) == 2


def test_train_state_round_trip_and_version_refusal():
    from paddle_tpu_torch.utils import resume
    np.random.seed(41)
    doc = resume.capture_train_state(cursor={"epoch": 1, "batch": 2},
                                     step=7)
    want = np.random.rand(3)
    np.random.seed(0)
    info = resume.apply_train_state(doc)
    assert np.array_equal(np.random.rand(3), want)
    assert info["cursor"] == {"epoch": 1, "batch": 2} and info["step"] == 7
    with pytest.raises(ValueError, match="newer"):
        resume.apply_train_state({**doc, "version": resume.STATE_VERSION + 1})
