"""The port's results store, trace loader and warehouse sink against the JAX
package's (CPU).

The port's ``data/results.py`` creates the JAX package's tables byte for
byte (``sqlite_master`` equal), so one results file holds the runs of both
packages; the same rows written through each store's loggers give equal
tables; ``load_reference_db`` equals the JAX loader bit for bit without
pandas; the port's ``SqliteSink`` writes what the JAX package's readers
query.
"""

import sqlite3

import numpy as np
import pytest
import torch
from test_traces import _make_reference_fixture_db

from p2pmicrogrid_tpu.data import results as jres
from p2pmicrogrid_tpu.data import traces as jtr
from p2pmicrogrid_tpu_torch.data import results as tres
from p2pmicrogrid_tpu_torch.data import traces as ttr
from p2pmicrogrid_tpu_torch.envs import EpisodeArrays, SlotOutputs
from p2pmicrogrid_tpu_torch.telemetry import SqliteSink, Telemetry


def _schema(path):
    con = sqlite3.connect(path)
    try:
        rows = con.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY type, name"
        ).fetchall()
        (version,) = con.execute("PRAGMA user_version").fetchone()
    finally:
        con.close()
    return rows, version


def _tables(path, skip_columns=("created",)):
    """{table: sorted rows} of every table, without the wall-clock columns."""
    con = sqlite3.connect(path)
    try:
        out = {}
        for (name,) in con.execute("SELECT name FROM sqlite_master WHERE type = 'table'"):
            cols = [r[1] for r in con.execute(f"PRAGMA table_info({name})")]
            keep = [c for c in cols if c not in skip_columns]
            out[name] = sorted(
                con.execute(f"SELECT {', '.join(keep)} FROM {name}").fetchall(), key=repr
            )
    finally:
        con.close()
    return out


def test_tables_are_the_jax_packages_byte_for_byte(tmp_path):
    paths = []
    for mod, name in ((jres, "jax.db"), (tres, "port.db")):
        path = str(tmp_path / name)
        mod.ResultsStore(path).close()
        paths.append(path)
    jax_schema, port_schema = (_schema(p) for p in paths)
    assert port_schema == jax_schema
    assert port_schema[1] == tres.TELEMETRY_SCHEMA_VERSION == jres.TELEMETRY_SCHEMA_VERSION
    assert len(port_schema[0]) > 10


def test_pre_warehouse_db_migrates_as_the_jax_package_does(tmp_path):
    """A results file with only the classic tables gains the same warehouse
    tables and version through either package's ``ensure_telemetry_schema``."""
    paths = []
    for mod, name in ((jres, "jax.db"), (tres, "port.db")):
        path = str(tmp_path / name)
        con = sqlite3.connect(path)
        for ddl in jres._DDL:
            con.execute(ddl)
        con.commit()
        assert mod.ensure_telemetry_schema(con) == jres.TELEMETRY_SCHEMA_VERSION
        con.close()
        paths.append(path)
    assert _schema(paths[0]) == _schema(paths[1])


def _eval_outputs(D=2, T=5, A=3, R=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    out = SlotOutputs(
        cost=f(D, T, A), reward=f(D, T, A), loss=f(D, T, A), p_grid=f(D, T, A),
        p_p2p=f(D, T, A), buy_price=f(D, T), injection_price=f(D, T), trade_price=f(D, T),
        t_in=f(D, T, A), hp_power_w=f(D, T, A), decisions=f(D, T, R, A), q=f(D, T, A),
    )
    arrays = EpisodeArrays(
        time=np.tile(np.arange(T, dtype=np.float32) / 96, (D, 1)), t_out=f(D, T),
        load_w=f(D, T, A), pv_w=f(D, T, A), next_time=f(D, T), next_load_w=f(D, T, A),
        next_pv_w=f(D, T, A),
    )
    return np.array([11, 12], dtype=np.int32), out, arrays


def test_same_rows_give_the_same_tables(tmp_path):
    """Every logger of both stores on the same values; the port's store is
    fed tensors (its loggers copy them to the host), the JAX package's numpy."""
    days, out, arrays = _eval_outputs()
    to_t = lambda tree: type(tree)(*(torch.from_numpy(np.asarray(x)) for x in tree))
    rng = np.random.default_rng(1)
    t = np.arange(4, dtype=np.float32) / 96
    cols = [rng.standard_normal((4, 2)).astype(np.float32) for _ in range(5)]
    paths = []
    for mod, name, wrap in ((jres, "jax.db", lambda x: x), (tres, "port.db", to_t)):
        path = str(tmp_path / name)
        with mod.ResultsStore(path) as store:
            mod.save_eval_outputs(
                store, "2-multi-agent-com-rounds-1-hetero", "tabular", True, days,
                wrap(out), wrap(arrays), config_hash="abc123", git_rev="rev",
            )
            mod.save_eval_outputs(store, "s", "dqn", False, days, wrap(out), wrap(arrays))
            store.log_training_progress("s", "tabular", 3, -1.5, 0.25)
            store.log_training_health("s", "ddpg", 4, 12.5, -3.0, "healthy")
            store.log_run_results("baseline-s", "rule-based", True, 19, t, *cols)
            store.log_sweep_point("ddpg-lr0.0001", 0, 1, -2.0, -3.0)
            store.log_predictions("forecast", ["2021-10-18"] * 2, ["00:15", "00:30"],
                                  [0.1, 0.2], [0.3, 0.4], [0.5, 0.6], [0.7, 0.8])
        paths.append(path)
    jax_tables, port_tables = (_tables(p) for p in paths)
    assert port_tables == jax_tables
    assert len(port_tables["test_results"]) == 2 * 5 * 3 + 4 * 2
    assert len(port_tables["rounds_comparison"]) == 2 * 5 * 2 * 3
    assert port_tables["eval_runs"][0][3] == "abc123"


@pytest.mark.parametrize("kw", [{}, {"days": [11, 18, 19]}, {"month": 9}],
                         ids=["all", "days", "other-month"])
def test_load_reference_db_equals_the_jax_loader(tmp_path, kw):
    """Day and month tags, the slot encoding, the float32 casts and the row
    order of the JAX loader's pandas merge, bit for bit; then the day split."""
    db = str(tmp_path / "fixture.db")
    _make_reference_fixture_db(db)
    ref, got = jtr.load_reference_db(db, **kw), ttr.load_reference_db(db, **kw)
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert g.tobytes() == r.tobytes()
    if ref.time.size:
        for r_split, g_split in zip(jtr.train_validation_test_split(ref),
                                    ttr.train_validation_test_split(got)):
            for r, g in zip(r_split, g_split):
                assert g.tobytes() == r.tobytes()


def test_load_reference_db_keeps_the_left_row_order(tmp_path):
    """Environment rows inserted out of time order, load rows in another
    order and one environment row without a load row: the JAX loader's inner
    merge keeps the environment table's order and drops the unmatched row."""
    db = str(tmp_path / "shuffled.db")
    con = sqlite3.connect(db)
    con.execute(jres._DDL[0])
    con.execute(jres._DDL[1])
    slots = [5, 1, 7, 3, 2]
    for s in slots:
        t = f"{s // 4:02d}:{(s % 4) * 15:02d}:00"
        con.execute("INSERT INTO environment VALUES (?,?,?,?,?,?,?,?)",
                    ("2021-10-12", t, "+02:00", 10.0 + s, 0.5, 0.7, 0.0, 0.1 * s))
    for s in reversed(slots[1:]):
        t = f"{s // 4:02d}:{(s % 4) * 15:02d}:00"
        con.execute("INSERT INTO load VALUES (?,?,?,?,?,?,?,?)",
                    ("2021-10-12", t, "+02:00", *(0.1 * s + 0.01 * c for c in range(5))))
    con.commit()
    con.close()
    ref, got = jtr.load_reference_db(db), ttr.load_reference_db(db)
    assert got.time.tolist() == [float(np.float32(s / 96)) for s in slots[1:]] == ref.time.tolist()
    for r, g in zip(ref, got):
        assert g.tobytes() == r.tobytes()


def test_sqlite_sink_rows_join_in_the_jax_packages_views(tmp_path):
    """A port run streamed through its ``SqliteSink`` and a port eval anchor:
    the JAX package's join and rollback views read them."""
    db = str(tmp_path / "w.db")
    tel = Telemetry(
        run_id="train-x", sinks=[SqliteSink(db, batch=4)],
        manifest={"config_hash": "cafe01", "git_rev": "r", "setting": "s", "backend": "cpu"},
    )
    for ep in range(10):
        tel.event("progress", episode=ep, avg_reward=-1.0 * ep)
    tel.gauge("train.env_steps_per_sec", 123.0)
    tel.counter("train.rollback", 2)
    with tel.span("train_block", episode0=0):
        pass
    tel.close()
    with tres.ResultsStore(db) as store:
        store.log_eval_run("s", "tabular", True, config_hash="cafe01", n_days=5,
                           total_cost_eur=-2.5)
    with jres.ResultsStore(db) as jstore:
        joined = jstore.query_telemetry_joined()
        rollbacks = jstore.query_rollback_view()
        gauges = jstore.get_run_gauges("train-x")
    assert [(r["run_id"], r["config_hash"], r["eval_setting"]) for r in joined] == [
        ("train-x", "cafe01", "s")
    ]
    assert gauges["train.env_steps_per_sec"] == 123.0
    assert rollbacks and rollbacks[0]["config_hash"] == "cafe01"
    con = sqlite3.connect(db)
    try:
        (n_progress,) = con.execute(
            "SELECT COUNT(*) FROM telemetry_points WHERE kind = 'progress'"
        ).fetchone()
        (n_spans,) = con.execute("SELECT COUNT(*) FROM telemetry_spans").fetchone()
    finally:
        con.close()
    assert n_progress == 10 and n_spans == 1
