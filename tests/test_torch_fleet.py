"""The port's fleet (policy, autoscaler signals, replicas, router)
against the JAX package's.

* The target-tracking policy, the schedule policy, ``histogram_quantile``
  and ``snapshot_signals`` give the reference's decisions on the same
  seeded signal sequences; ``parse_prom_text`` reads back what the
  port's ``render`` writes (and what an ``EndpointSignalSource`` scrapes
  from a live ``MetricsHTTPServer`` on localhost).
* The router over the port's engines (CPU): prefix-affinity placement,
  the skew escape, drain and retire, ejection with re-routing, hedged
  dispatch, warm recovery with identical tokens, and the corrupt
  ``serve.migrate`` and ``serve.handoff`` wires degrading to cold paths
  with identical tokens.
* The two-tier (prefill→decode) fleet's streams equal one ``"both"``
  engine's and the JAX two-tier fleet's; pure roles; every handoff warm;
  modeled KV-snapshot bytes equal the measured ones; per-tier scaling.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.fleet import policy as jpolicy
from horovod_tpu.fleet.autoscaler import parse_prom_text as j_parse
from horovod_tpu.fleet.router import FleetRouter as JaxRouter
from horovod_tpu.models.transformer import Transformer as JaxTransformer
from horovod_tpu.models.transformer import TransformerConfig as JaxConfig
from horovod_tpu.serving import ServeConfig as JaxServeConfig
from horovod_tpu.serving import ServingEngine as JaxEngine
from horovod_tpu_torch import chaos
from horovod_tpu_torch.fleet import policy as tpolicy
from horovod_tpu_torch.fleet.autoscaler import (
    EndpointSignalSource, maybe_training_autoscaler, parse_prom_text,
    register_targets_endpoint,
)
from horovod_tpu_torch.fleet.replica import ServingReplica
from horovod_tpu_torch.fleet.router import FleetRouter
from horovod_tpu_torch.metrics import exposition as expo
from horovod_tpu_torch.metrics import instruments as _instr
from horovod_tpu_torch.models import TransformerConfig, params_from_flax
from horovod_tpu_torch.ops.comm_model import modeled_kvsnap_bytes
from horovod_tpu_torch.serving import ServeConfig, ServingEngine
from horovod_tpu_torch.trace import flight as _flight


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- policy decisions ---------------------------------------------------------


def _decisions(mod, seed):
    """A seeded run of both policy kinds and the quantile helper over
    random signal sequences; every decision as a plain tuple."""
    rs = np.random.RandomState(seed)
    out = []
    p = mod.TargetTrackingPolicy(
        [mod.Target("p99_ttft", 0.5), mod.Target("queue_depth", 4.0),
         mod.Target("throughput", 50.0, invert=True)],
        min_size=1, max_size=6, hysteresis=2, cooldown_s=3.0,
        scale_in_at=0.5, deadband=0.1)
    size, now = 2, 0.0
    for _ in range(300):
        sig = {}
        for name, scale in (("p99_ttft", 1.2), ("queue_depth", 9.0),
                            ("throughput", 120.0)):
            if rs.random_sample() < 0.8:
                sig[name] = float(rs.random_sample() * scale)
        now += float(rs.random_sample() * 2)
        d = p.evaluate(sig, size, now)
        out.append((d.direction, d.desired, d.reason))
        if d.direction != "hold" and rs.random_sample() < 0.7:
            size = d.desired
            p.note_applied(now)
    sp = mod.SchedulePolicy.parse("0:2, 4:4, 8:1, 11:3")
    for t in np.cumsum(rs.random_sample(40)):
        d = sp.evaluate({}, int(rs.randint(1, 5)), 100.0 + float(t))
        out.append((d.direction, d.desired, d.reason))
    for _ in range(50):
        bounds = sorted(set(np.round(rs.random_sample(5), 3).tolist()))
        counts = rs.randint(0, 20, size=len(bounds) + 1).tolist()
        q = float(rs.random_sample())
        out.append(mod.histogram_quantile(bounds, counts, q))
    return out


def test_policy_decisions_match_jax():
    for seed in range(3):
        assert _decisions(tpolicy, seed) == _decisions(jpolicy, seed)


def test_policy_env_and_decode_policy_match_jax(monkeypatch):
    for mod in (tpolicy, jpolicy):
        assert mod.decode_policy_from_env() is None
        assert mod.plan_from_env() is None
    monkeypatch.setenv("HVD_TPU_FLEET_TTFT_SLO", "0.4")
    monkeypatch.setenv("HVD_TPU_FLEET_THROUGHPUT_FLOOR", "50")
    monkeypatch.setenv("HVD_TPU_FLEET_MAX", "6")
    monkeypatch.setenv("HVD_TPU_FLEET_DECODE_TPS_FLOOR", "30")
    monkeypatch.setenv("HVD_TPU_FLEET_PLAN", "0:2,5:4")
    got = [(m.TargetTrackingPolicy.from_env().max_size,
            sorted((s, t.value, t.invert) for s, t in
                   m.TargetTrackingPolicy.from_env().targets().items()),
            sorted((s, t.value, t.invert) for s, t in
                   m.decode_policy_from_env().targets().items()),
            m.plan_from_env().evaluate({}, 2, 0.0).desired)
           for m in (tpolicy, jpolicy)]
    assert got[0] == got[1]


def test_snapshot_signals_match_jax():
    buckets = [0.1, 0.5, 1.0]
    snap = {"metrics": {
        "hvd_tpu_serve_queue_depth": {
            "kind": "gauge", "labelnames": ["rank"],
            "series": [[["0"], 3.0], [["1"], 5.0]]},
        "hvd_tpu_serve_token_latency_seconds": {
            "kind": "histogram", "labelnames": ["kind"],
            "buckets": buckets,
            "series": [[["first"], {"buckets": [0, 10, 0, 0], "sum": 3.0,
                                    "count": 10}]]},
        "hvd_tpu_serve_steps_total": {
            "kind": "counter", "labelnames": [], "series": [[[], 120.0]]},
    }}
    prev = {"metrics": {"hvd_tpu_serve_steps_total": {
        "kind": "counter", "labelnames": [], "series": [[[], 20.0]]}}}
    got = tpolicy.snapshot_signals(snap, prev, dt=10.0)
    assert got == jpolicy.snapshot_signals(snap, prev, dt=10.0)
    assert got["queue_depth"] == 8.0
    assert got["p99_ttft"] == pytest.approx(0.496)


def test_prom_text_round_trip_and_live_endpoint():
    """What the port's ``render`` writes, both packages' parsers read
    back alike; an EndpointSignalSource scrapes a live endpoint, and
    the targets endpoint retunes a policy over HTTP."""
    from horovod_tpu_torch.metrics import registry as reg_mod

    # a registry of its own: the process-wide one carries other tests'
    # observations
    reg = reg_mod.MetricsRegistry()
    same = lambda kind, m, **kw: kind(  # noqa: E731
        m.name, m.documentation, m.labelnames, registry=reg, **kw)
    depth = same(reg_mod.gauge, _instr.SERVE_QUEUE_DEPTH)
    lat = same(reg_mod.histogram, _instr.SERVE_TOKEN_LATENCY,
               buckets=_instr.SERVE_TOKEN_LATENCY.bucket_bounds)
    steps = same(reg_mod.counter, _instr.SERVE_STEPS)
    depth.set(7.0)
    lat.labels("first").observe(0.3)
    steps.labels("decode").inc(5)
    text = expo.render(reg)
    parsed = parse_prom_text(text)
    assert parsed == j_parse(text)
    assert parsed[("hvd_tpu_serve_queue_depth", ())] == 7.0
    assert parsed == parse_prom_text(expo.render(reg))
    srv = expo.MetricsHTTPServer(0, addr="127.0.0.1", registry=reg)
    try:
        url = f"http://127.0.0.1:{srv.port}"
        src = EndpointSignalSource([url], clock=iter([0.0, 10.0]).__next__)
        s1 = src()
        assert s1["queue_depth"] == 7.0
        assert 0.25 <= s1["p99_ttft"] <= 0.5
        steps.labels("decode").inc(20)
        assert src()["throughput"] == pytest.approx(2.0)
        policy = tpolicy.TargetTrackingPolicy(
            [tpolicy.Target("p99_ttft", 0.5)])
        register_targets_endpoint(policy)
        with urllib.request.urlopen(
                url + "/control/fleet/targets?set=p99_ttft:0.125") as r:
            body = json.load(r)
        assert body["targets"]["p99_ttft"]["value"] == 0.125
        assert policy.targets()["p99_ttft"].value == 0.125
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/control/fleet/targets?set=x")
        assert ei.value.code == 400
    finally:
        expo.unregister_control_handler("fleet/targets")
        srv.close()


_NEW_INSTRUMENTS = (
    "SERVE_SPEC_DRAFTED", "SERVE_SPEC_ACCEPTED", "SERVE_SPEC_ROLLED_BACK",
    "SERVE_SPEC_ACCEPT_RATE", "SERVE_MIGRATIONS", "SERVE_HEDGES",
    "SERVE_RECOVERY_SECONDS", "SERVE_HANDOFFS", "SERVE_HANDOFF_SECONDS",
    "SERVE_MIGRATED_BYTES", "FLEET_DESIRED_SIZE", "FLEET_SCALE_EVENTS",
    "FLEET_REPLICAS", "FLEET_ROUTED", "FLEET_ROUTER_P99_TTFT",
    "FLEET_REPLICA_SUSPECTS", "TRACE_BUNDLES", "RETRY_ATTEMPTS",
)


@pytest.mark.parametrize("name", _NEW_INSTRUMENTS)
def test_instruments_match_reference(name):
    """Name, kind, help, label names and buckets of every instrument
    this slice books are the reference's."""
    from horovod_tpu.metrics import instruments as jinstr

    t, j = getattr(_instr, name), getattr(jinstr, name)
    assert type(t).__name__ == type(j).__name__
    assert (t.name, t.documentation, tuple(t.labelnames)) == \
        (j.name, j.documentation, tuple(j.labelnames))
    if hasattr(j, "bucket_bounds"):
        assert t.bucket_bounds == j.bucket_bounds


def test_trace_sites_cover_every_recorded_site():
    """Every span/event literal the port records is in the port's
    catalogue, and the catalogue is a subset of the reference's."""
    import re
    from pathlib import Path

    from horovod_tpu import trace as jtrace
    from horovod_tpu_torch import trace as ttrace

    root = Path(__file__).resolve().parents[1] / "horovod_tpu_torch"
    pat = re.compile(r"trace\.(?:span|event|add_span)\(\s*\"([a-z_.]+)\"")
    used = {m for f in root.rglob("*.py") for m in pat.findall(f.read_text())}
    assert {"serve.handoff", "serve.migrate", "serve.spec_verify",
            "fleet.route"} <= used
    assert used <= set(ttrace.SITES), used - set(ttrace.SITES)
    assert set(ttrace.SITES) <= set(jtrace.SITES)


def test_training_autoscaler_waits_for_elastic(monkeypatch):
    """The elastic driver's resize hook (it raised before the driver was
    ported): nothing armed -> None; a drill plan -> a schedule
    autoscaler; SLO targets without a scrape source -> None."""
    monkeypatch.delenv("HVD_TPU_FLEET_PLAN", raising=False)
    assert maybe_training_autoscaler(lambda n: n, lambda: 2, min_size=1,
                                     max_size=None) is None
    monkeypatch.setenv("HVD_TPU_FLEET_PLAN", "0:2,5:4")
    sc = maybe_training_autoscaler(lambda n: n, lambda: 2, min_size=1,
                                   max_size=4)
    assert sc is not None and isinstance(sc.policy, tpolicy.SchedulePolicy)
    monkeypatch.delenv("HVD_TPU_FLEET_PLAN")
    monkeypatch.setenv("HVD_TPU_FLEET_TTFT_SLO", "0.5")
    monkeypatch.delenv("HVD_TPU_FLEET_SCRAPE", raising=False)
    assert maybe_training_autoscaler(lambda n: n, lambda: 2, min_size=1,
                                     max_size=4) is None


# -- the router over the port's engines ---------------------------------------

SERVE = dict(block_size=8, token_budget=128, watermark=2, prefill_tiers=(32,),
             decode_tiers=(1, 2), prefill_chunk=8)


@pytest.fixture(scope="module")
def fleet():
    shape = dict(vocab_size=97, num_layers=1, num_heads=2, num_kv_heads=2,
                 head_dim=8, max_seq_len=48)
    jc = JaxConfig(dtype=jnp.float32, **shape)
    tc = TransformerConfig(dtype=torch.float32, **shape)
    params = JaxTransformer(jc).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        train=False)["params"]
    sd = params_from_flax(jax.tree.map(np.asarray, params), tc, device="cpu")

    def build(role="both"):
        return ServingEngine(tc, sd, serve=ServeConfig(**SERVE),
                             device="cpu", role=role)

    def jax_build(role="both"):
        return JaxEngine(jc, params, serve=JaxServeConfig(**SERVE),
                         role=role)

    return tc, build, jax_build


def _prompts(seed, n, lo=9, hi=14):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 90, size=rs.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _reference(build, prompts, gen):
    eng = build()
    ids = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    out = eng.run()
    return [out[i] for i in ids]


def test_router_affinity_and_skew_escape(fleet):
    _tc, build, _jb = fleet
    router = FleetRouter(build, replicas=2, mode="affinity", max_skew=2)
    template = np.random.RandomState(0).randint(1, 90, size=24).astype(
        np.int32)
    g0 = router.submit(np.concatenate([template, [3, 4]]), 2)
    first = router._placed[g0].replica
    router.run_until_drained()
    assert router.route_counts["least_queue"] == 1
    assert first.cached_prefix_blocks(template) > 0
    other = next(r for r in router.replicas if r is not first)
    assert other.cached_prefix_blocks(template) == 0
    g1 = router.submit(np.concatenate([template, [9]]), 2)
    assert router._placed[g1].replica is first
    assert router.route_counts["affinity"] == 1
    router.run_until_drained()
    # pile queued work onto the cache-hot replica past the skew bound
    for i in range(4):
        router.submit(np.concatenate([template, [i + 2]]), 1)
    assert router.route_counts["least_queue"] >= 2
    assert other.engine.scheduler.queue_depth() > 0
    router.run_until_drained()
    assert router.all_compile_free()


def test_router_drain_retire_and_scale(fleet):
    _tc, build, _jb = fleet
    policy = tpolicy.TargetTrackingPolicy(
        [tpolicy.Target("queue_depth", 2.0)], min_size=1, max_size=2,
        hysteresis=3, cooldown_s=0.0, scale_in_at=0.5)
    router = FleetRouter(build, replicas=1, policy=policy, spares=1)
    assert router.size == 1 and len(router.replicas) == 2
    gids = [router.submit(p, 2) for p in _prompts(2, 8, lo=5, hi=12)]
    deadline = time.time() + 30
    while router.size < 2 and time.time() < deadline:
        router.step()
    assert router.size == 2 and ("out", 2) in router.scale_events
    deadline = time.time() + 30
    while (router.size > 1 or any(r.state == "draining"
                                  for r in router.replicas)) \
            and time.time() < deadline:
        router.step()
    router.run_until_drained()
    assert router.size == 1 and len(router.retired) == 1
    assert all(g in router.results for g in gids)
    assert router.all_compile_free() and router.all_ttfts()


def test_replica_lifecycle(fleet):
    _tc, build, _jb = fleet
    r = ServingReplica("t", build)
    r.spawn(park=True)
    assert r.state == "parked" and not r.accepting
    assert r.engine.snap_source == "t"
    assert r.warmed_programs == r.engine.program_count > 0
    with pytest.raises(RuntimeError, match="not accepting"):
        r.submit(np.ones((4,), np.int32), 1)
    r.unpark()
    r.submit(np.arange(1, 6, dtype=np.int32), 2)
    with pytest.raises(RuntimeError, match="drain before retire"):
        r.drain() or r.retire()
    while r.has_work:
        r.step()
    assert r.drained and r.healthy() and r.compile_free
    r.retire()
    assert r.state == "retired" and r.engine is None and r.ttft_samples()


def test_router_ejects_raising_replica_and_reroutes(fleet, monkeypatch):
    monkeypatch.setenv("HVD_TPU_FLEET_REPLICA_ERRORS", "2")
    _tc, build, _jb = fleet
    router = FleetRouter(build, replicas=2, mode="round_robin")
    prompts = _prompts(3, 8, lo=10, hi=11)
    gids = [router.submit(p, 4) for p in prompts[:4]]
    victim = router.replicas[0]
    on_victim = [g for g, p in router._placed.items() if p.replica is victim]

    def boom(*a, **k):
        raise RuntimeError("card on fire")

    victim.engine.submit = boom
    gids += [router.submit(p, 4) for p in prompts[4:]]
    assert victim.suspect and not victim.accepting
    for g in on_victim:
        assert router._placed[g].rerouted
    res = router.run_until_drained()
    want = _reference(build, prompts, 4)
    for g, w in zip(gids, want):
        np.testing.assert_array_equal(res[g], w)
    assert victim.state == "retired" and router.size == 1
    # a client's invalid request never books replica health
    with pytest.raises(ValueError):
        router.submit(np.arange(1, 200, dtype=np.int32), 4)
    assert not router.replicas[0].suspect


def _decode_until(router, victim, n, timeout_s=60):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        router.step()
        seqs = list(victim.engine.scheduler.running)
        if seqs and all(len(s.generated) >= n for s in seqs):
            return
    raise AssertionError("victim never reached the interruption point")


@pytest.mark.parametrize("corrupt", [False, True])
def test_recovery_warm_and_corrupt_migrate_cold(fleet, monkeypatch, tmp_path,
                                                corrupt):
    """A replica killed mid-decode: every request completes on the
    survivor with the control run's tokens; the snapshot re-registers
    warm, or, with the ``serve.migrate`` wire corrupted, the chain check
    rejects it and recovery goes cold.  A replica_loss flight bundle is
    written."""
    monkeypatch.setenv("HVD_TPU_FLEET_REPLICA_ERRORS", "1")
    monkeypatch.setenv("HVD_TPU_TRACE_BUNDLE_DIR", str(tmp_path))
    _flight._last_dump.clear()
    _tc, build, _jb = fleet
    prompts = _prompts(18, 4, lo=10, hi=11)
    want = _reference(build, prompts, 12)
    if corrupt:
        chaos.configure("serve.migrate:corrupt,prob=1", seed=7)
    try:
        router = FleetRouter(build, replicas=2, mode="round_robin")
        gids = [router.submit(p, 12) for p in prompts]
        victim = router.replicas[0]
        _decode_until(router, victim, 7)

        def boom():
            raise RuntimeError("card on fire")

        victim.engine.step = boom
        res = router.run_until_drained()
        fired = [t["site"] for t in chaos.injection_trace()]
    finally:
        chaos.clear()
    for g, w in zip(gids, want):
        np.testing.assert_array_equal(res[g], w)
    paths = {x["path"] for x in router.recovery}
    assert paths == ({"cold"} if corrupt else {"warm"})
    assert ("serve.migrate" in fired) == corrupt
    assert victim.state == "retired" and router.all_compile_free()
    bundles = [p for p in os.listdir(tmp_path)
               if p.startswith("bundle-replica_loss-")]
    assert bundles
    bundle = _flight.read_bundle(str(tmp_path / bundles[0]))
    assert bundle["reason"] == "replica_loss"


def test_hedged_dispatch_first_wins_and_budget(fleet, monkeypatch):
    monkeypatch.setenv("HVD_TPU_SERVE_HEDGE", "1")
    monkeypatch.setenv("HVD_TPU_SERVE_HEDGE_BUDGET", "1")
    _tc, build, _jb = fleet
    prompt = np.arange(1, 9, dtype=np.int32)
    want = _reference(build, [prompt], 3)[0]
    t = [0.0]
    router = FleetRouter(build, replicas=2, mode="round_robin",
                         clock=lambda: t[0])
    router._ttfts.extend([0.001] * 16)
    g = router.submit(prompt, 3)
    primary = router._placed[g].replica
    t[0] = 1.0
    router._maybe_hedge()
    p = router._placed[g]
    assert p.hedged and p.hedge is not None and p.hedge[0] is not primary
    res = router.run_until_drained()
    np.testing.assert_array_equal(res[g], want)
    assert router.hedges["won"] + router.hedges["lost"] == 1
    for r in router.replicas:
        assert not r.engine.scheduler.running
        assert not r.engine.scheduler.pending
    monkeypatch.setenv("HVD_TPU_SERVE_HEDGE_BUDGET", "0")
    r2 = FleetRouter(build, replicas=2, mode="round_robin",
                     clock=lambda: t[0])
    r2._ttfts.extend([0.001] * 16)
    g2 = r2.submit(prompt, 3)
    t[0] = 3.0
    r2._maybe_hedge()
    assert r2._placed[g2].hedge is None
    assert r2.hedges == {"won": 0, "lost": 0, "suppressed": 1}
    np.testing.assert_array_equal(r2.run_until_drained()[g2], want)


# -- the two-tier fleet -------------------------------------------------------


def test_two_tier_fleet_matches_single_engine_and_jax_fleet(fleet):
    """Decode on handed-off blocks equals decode on local blocks, and
    the JAX two-tier fleet's streams; the prefill replica never runs a
    decode step; every handoff warm; modeled bytes == measured."""
    tc, build, jax_build = fleet
    prompts = _prompts(20, 8)
    want = _reference(build, prompts, 12)
    before = _instr.SERVE_MIGRATED_BYTES.get()
    warm0 = _instr.SERVE_HANDOFFS.labels("warm").get()
    router = FleetRouter(build, replicas=2, prefill_replicas=1)
    assert router.disagg
    pre = [r for r in router.replicas if r.tier == "prefill"]
    dec = [r for r in router.replicas if r.tier == "decode"]
    assert len(pre) == 1 and len(dec) == 2
    assert pre[0].engine.role == "prefill"
    assert pre[0].warmed_programs < dec[0].warmed_programs
    decode_calls = []
    pre[0].engine._decode_step = lambda *a, **k: decode_calls.append(a)
    gids = [router.submit(p, 12) for p in prompts]
    got = router.run_until_drained()
    for i, g in enumerate(gids):
        np.testing.assert_array_equal(got[g], want[i], err_msg=f"req {i}")
    assert not decode_calls and pre[0].engine.spec_steps == 0
    assert all(k[0] == "mixed" for k in pre[0].engine._progs)
    assert router.handoffs == {"warm": len(prompts), "cold": 0}
    assert _instr.SERVE_HANDOFFS.labels("warm").get() - warm0 == len(prompts)
    assert router.all_compile_free()
    for rec in router.handoff_records:
        m = modeled_kvsnap_bytes(rec["blocks"], SERVE["block_size"],
                                 tc.num_layers, tc.kv_heads, tc.head_dim,
                                 tc.dtype)
        assert rec["bytes"] == m["wire_bytes"] > 0
    assert router.migrated_bytes == sum(r["bytes"] for r in
                                        router.handoff_records)
    assert _instr.SERVE_MIGRATED_BYTES.get() - before == \
        router.migrated_bytes
    jr = JaxRouter(jax_build, replicas=2, prefill_replicas=1)
    jgids = [jr.submit(p, 12) for p in prompts]
    jgot = jr.run_until_drained()
    for g, jg in zip(gids, jgids):
        np.testing.assert_array_equal(got[g], np.asarray(jgot[jg]))
    assert jr.handoffs == router.handoffs
    assert [r["bytes"] for r in jr.handoff_records] == \
        [r["bytes"] for r in router.handoff_records]


def test_handoff_chaos_corrupt_degrades_cold(fleet):
    _tc, build, _jb = fleet
    prompts = _prompts(25, 5)
    want = _reference(build, prompts, 8)
    chaos.configure("serve.handoff:corrupt,prob=1", seed=7)
    try:
        router = FleetRouter(build, replicas=1, prefill_replicas=1)
        gids = [router.submit(p, 8) for p in prompts]
        got = router.run_until_drained()
        fired = chaos.injection_trace()
    finally:
        chaos.clear()
    for g, w in zip(gids, want):
        np.testing.assert_array_equal(got[g], w)
    assert router.handoffs == {"warm": 0, "cold": len(prompts)}
    assert router.migrated_bytes == 0
    assert any(ev["site"] == "serve.handoff" for ev in fired)


def test_per_tier_scaling_and_decode_rate_signal(fleet, monkeypatch):
    _tc, build, _jb = fleet
    mk = dict(min_size=1, max_size=3, hysteresis=1, cooldown_s=0.0)
    router = FleetRouter(
        build, replicas=1, prefill_replicas=1,
        policy=tpolicy.TargetTrackingPolicy(
            [tpolicy.Target("p99_ttft", 0.5)], **mk),
        decode_policy=tpolicy.TargetTrackingPolicy(
            [tpolicy.Target("decode_tokens_per_s", 100.0, invert=True)],
            **mk))
    monkeypatch.setattr(router, "signals", lambda: {
        "p99_ttft": 1.0, "decode_tokens_per_s": 500.0})
    router._maybe_scale()
    assert router.tier_size("prefill") == 2 and router.tier_size("decode") == 1
    assert router.replicas[-1].engine.role == "prefill"
    monkeypatch.setattr(router, "signals", lambda: {
        "p99_ttft": 0.2, "decode_tokens_per_s": 10.0})
    router._maybe_scale()
    assert router.tier_size("decode") >= 2
    assert router.replicas[-1].engine.role == "both"
    t = [50.0]
    r2 = FleetRouter(build, replicas=2, prefill_replicas=1,
                     clock=lambda: t[0])
    assert "decode_tokens_per_s" not in r2.signals()
    r2._decode_tokens += 120
    t[0] += 2.0
    assert r2.signals()["decode_tokens_per_s"] == pytest.approx(30.0)
