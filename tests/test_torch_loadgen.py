"""The port's load generator against the JAX package's (CPU).

Its arrival processes (Poisson, the MMPP-2 bursts, ``make_arrivals``) and
``synthetic_obs`` equal the JAX package's bit for bit for the same seeds;
``plan_open_loop`` gives the same schedule on a modeled service clock; and
``serve_bench`` on the port's engine with a modeled clock emits the JAX
package's rows (the span timings aside) for the same bundle. The network
loadgen, the wire benches and ``serve_bench_continuous_compare`` drive the
port's gateway: every request answered, the continuous and microbatch arms
bit for bit equal to a direct engine.
"""

import numpy as np
import pytest

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.serve import PolicyEngine as JaxEngine
from p2pmicrogrid_tpu.serve import loadgen as jl
from p2pmicrogrid_tpu.serve.export import export_policy_bundle as jax_export
from p2pmicrogrid_tpu.train import init_policy_state as j_init_policy_state
from p2pmicrogrid_tpu_torch.serve import PolicyEngine
from p2pmicrogrid_tpu_torch.serve import loadgen as tl
from p2pmicrogrid_tpu_torch.serve.continuous import serve_bench_continuous_compare
from p2pmicrogrid_tpu_torch.serve.gateway import AdmissionConfig, GatewayServer, build_gateway

A = 3


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A tabular bundle of a table that is not all ties, exported by the JAX
    package."""
    import jax

    cfg = jcfg.default_config(sim=jcfg.SimConfig(n_agents=A))
    st = j_init_policy_state(cfg, jax.random.PRNGKey(0))
    q = np.random.default_rng(3).standard_normal(st.q_table.shape, dtype=np.float32)
    st = st._replace(q_table=jax.numpy.asarray(q))
    return jax_export(cfg, st, str(tmp_path_factory.mktemp("loadgen") / "b"))


@pytest.mark.parametrize("seed", [0, 7])
def test_arrivals_and_obs_are_the_jax_packages(seed):
    np.testing.assert_array_equal(tl.poisson_arrivals(300.0, 257, seed), jl.poisson_arrivals(300.0, 257, seed))
    np.testing.assert_array_equal(
        tl.bursty_arrivals(200.0, 300, burst_factor=8.0, burst_dwell_s=0.1, seed=seed),
        jl.bursty_arrivals(200.0, 300, burst_factor=8.0, burst_dwell_s=0.1, seed=seed),
    )
    for bf in (1.0, 6.0):
        got, got_cfg = tl.make_arrivals(250.0, 128, seed=seed, burst_factor=bf, burst_dwell_s=0.2)
        ref, ref_cfg = jl.make_arrivals(250.0, 128, seed=seed, burst_factor=bf, burst_dwell_s=0.2)
        np.testing.assert_array_equal(got, ref)
        assert got_cfg == ref_cfg
    np.testing.assert_array_equal(tl.synthetic_obs(64, A, seed=seed), jl.synthetic_obs(64, A, seed=seed))
    ns = np.arange(1, 9, dtype=np.float64) * 1e-3
    np.testing.assert_array_equal(tl.gaps_to_schedule_ns(ns), jl.gaps_to_schedule_ns(ns))


def test_plan_open_loop_is_the_jax_packages():
    arrivals = jl.poisson_arrivals(500.0, 200, seed=2)
    service = lambda i, j: 0.0004 + 0.0001 * (j - i)  # noqa: E731
    bucket = lambda n: 1 << (n - 1).bit_length()  # noqa: E731
    got = tl.plan_open_loop(arrivals, service, max_batch=8, max_wait_s=0.003, bucket_fn=bucket)
    ref = jl.plan_open_loop(arrivals, service, max_batch=8, max_wait_s=0.003, bucket_fn=bucket)
    np.testing.assert_array_equal(got.latencies_s, ref.latencies_s)
    assert got.batch_sizes == ref.batch_sizes and got.padding_waste == ref.padding_waste
    assert got.throughput_rps == ref.throughput_rps


def test_serve_bench_rows_match_jax_on_a_modeled_clock(bundle):
    service = lambda i, j: 0.0005 * (1 + (j - i) / 8)  # noqa: E731
    kw = dict(rate_hz=400.0, n_requests=96, seed=4, service_time_fn=service)
    got = tl.serve_bench(PolicyEngine(bundle_dir=bundle, max_batch=8, device="cpu"), **kw)
    ref = jl.serve_bench(JaxEngine(bundle_dir=bundle, max_batch=8, device="cpu"), **kw)
    assert [r["metric"] for r in got] == [r["metric"] for r in ref]
    timings = {k for k in ref[-1] if k.startswith(("compile", "execute"))}
    for g, r in zip(got, ref):
        assert {k: v for k, v in g.items() if k not in timings} == {
            k: v for k, v in r.items() if k not in timings
        }


def test_network_loadgen_and_continuous_compare_on_the_port_gateway(bundle):
    gateway = build_gateway([bundle], max_batch=8, device="cpu", mux_port=0,
                            admission=AdmissionConfig(max_queue_depth=1 << 16, wait_budget_ms=1e9))
    server = GatewayServer(gateway)
    host, port = server.start()
    try:
        obs = tl.synthetic_obs(24, A, seed=1)
        arrivals = tl.poisson_arrivals(200.0, 24, seed=1)
        households = [f"house-{i}" for i in range(6)]
        for transport, p in (("http", port), ("mux", gateway.mux_port)):
            res = tl.run_network_loadgen(host, p, obs, arrivals, households, transport=transport,
                                         record_actions=True)
            assert res.n_ok == 24 and (res.statuses == 200).all()
            want = PolicyEngine(bundle_dir=bundle, max_batch=8, device="cpu").act(obs)
            np.testing.assert_array_equal(np.asarray(res.actions, np.float32), want)
        head = tl.serve_bench_network(host, port, A, rate_hz=200.0, n_requests=16, n_households=4)[-1]
        assert head["metric"] == "serve_bench_network" and head["n_ok"] == 16
        row = tl.serve_bench_wire_compare(host, port, gateway.mux_port, A, rate_hz=200.0, n_requests=16)
        assert row["metric"] == "wire_comparison" and row["http_n_ok"] == row["mux_n_ok"] == 16
    finally:
        server.stop()
    rows = serve_bench_continuous_compare(bundle, rate_hz=300.0, n_requests=48, n_households=8,
                                          max_batch=8, device="cpu")
    head = rows[-1]
    assert head["metric"] == "serve_continuous" and head["bit_exact_stateless"]
    assert head["n_compared"] == 48 and head["n_ok"] == head["micro_n_ok"] == 48
