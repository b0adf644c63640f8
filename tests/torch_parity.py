"""Helpers shared by the tests/test_torch_*.py parity tests (the JAX
reference and the PyTorch port in one process, data passed as numpy).

Import :func:`jax_compile_cache_off` into a test module to use it: it is
an autouse module fixture.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def jax_compile_cache_off():
    """Run the module's JAX reference computations without the persistent
    compilation cache, restoring the hooks afterwards.  conftest.py wraps
    jax's ``_cache_read``/``_cache_write`` with the four-argument
    signature of older jax; the installed jax calls them with five, so a
    JAX compile under those wrappers fails at the cache lookup.  The
    parity tests only need JAX to compute: a miss-always read and a
    no-op write keep them off the cache entirely."""
    from jax._src import compiler

    saved = compiler._cache_read, compiler._cache_write
    compiler._cache_read = lambda *args, **kwargs: (None, None)
    compiler._cache_write = lambda *args, **kwargs: None
    try:
        yield
    finally:
        compiler._cache_read, compiler._cache_write = saved


def to_torch(a) -> torch.Tensor:
    """A numpy (or numpy-convertible) array as a CPU tensor."""
    return torch.from_numpy(np.array(a))


def tiny_models():
    """(JAX config, JAX params, port config, port params): the JAX tiny
    model (seed 0) and the same weights carried across by
    ``convert.params_from_jax``."""
    import jax

    from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
    from tfmesos_tpu_torch import convert
    from tfmesos_tpu_torch.models import presets

    jcfg, jparams = jax_tiny_model(seed=0)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, presets.tiny_model()[0], tparams


def batcher_streams(completions) -> dict:
    """{rid: tokens} of a batcher run's completions."""
    return {c.rid: list(c.tokens) for c in completions}


class Golden:
    """Streams of the JAX batcher in its synchronous, phase-split, one
    token a tick mode (the golden every schedule mode is held to),
    computed once per (requests, config) and kept for the module."""

    def __init__(self, models):
        self.models = models
        self._memo = {}

    def __call__(self, name: str, specs, **kw) -> dict:
        """``specs``: [(prompt, max_new_tokens)]; ``kw``: the batcher's
        arguments (``rng`` as a seed int, made a JAX key here)."""
        import jax

        from tfmesos_tpu import serving as js

        key = (name, tuple(sorted((k, repr(v)) for k, v in kw.items())))
        if key not in self._memo:
            jcfg, jparams = self.models[:2]
            if "rng" in kw:
                kw = dict(kw, rng=jax.random.PRNGKey(kw["rng"]))
            b = js.ContinuousBatcher(jcfg, jparams, **kw)
            self._memo[key] = batcher_streams(b.run(
                js.Request(prompt=p.copy(), max_new_tokens=n)
                for p, n in specs))
            assert b.alloc.rows == {}
        return self._memo[key]


# -- fleet replicas of both packages in one process --------------------------


def replica_environ(generation: int = 0, job: str = "", index: str = ""
                    ) -> dict:
    """The task env a replica reads its launch identity from."""
    env = {"TPUMESOS_GENERATION": str(generation)}
    if job:
        env.update(TPUMESOS_JOB_NAME=job, TPUMESOS_TASK_INDEX=index)
    return env


def jax_replica(argv, token: str, environ=None):
    """A JAX replica in this process, assembled as
    ``tfmesos_tpu/fleet/replica.py:main`` assembles it (``:1366-1629``:
    build, the KV fabric behind ``--registry`` when ``--kv-tier-mb`` /
    ``--kv-tier-dir`` give a tier, the warm-pool adoption, handler,
    heartbeat fields, register, warm up, serve) without the gang and the
    signal wait.  Returns (server, serving or None, batcher)."""
    from tfmesos_tpu.fleet import replica as jr

    args = jr.build_parser().parse_args(argv)
    environ = replica_environ() if environ is None else environ
    generation = int(environ.get("TPUMESOS_GENERATION", "0") or 0)
    job = environ.get("TPUMESOS_JOB_NAME", "")
    idx = environ.get("TPUMESOS_TASK_INDEX", "")
    node = f"{job}:{idx}" if job and idx != "" else ""
    batcher = jr.build_batcher(args, token, generation, node=node)
    tiered = (batcher.kv_tier is not None
              and batcher.kv_tier_bypass_reason is None)
    fabric = None
    if args.registry and tiered:        # fleet/replica.py:1423-1438
        from tfmesos_tpu.fleet.kvtier import KVFabric

        fabric = KVFabric(batcher.kv_tier, token=token,
                          registry_addr=args.registry,
                          replication=args.kv_replication,
                          placement=args.kv_placement)
        batcher.kv_tier = fabric
    model_state = {"model_id": args.model_id or "",
                   "warm_pool": bool(args.warm_pool),
                   "pool_capable": bool(args.warm_pool)}
    cell = []

    def adopt_fn(head, reply):          # fleet/replica.py:1440-1485
        from tfmesos_tpu.fleet.registry import validate_model_id

        mid = head.get("id")
        try:
            model_id = validate_model_id(head.get("model_id"))
            seed = int(head.get("seed") or 0)
        except (TypeError, ValueError) as e:
            reply({"op": "error", "id": mid, "kind": "bad_request",
                   "error": str(e)})
            return
        if model_state["model_id"] or model_state.get("adopting"):
            reply({"op": "error", "id": mid, "kind": "bad_request",
                   "error": f"already serving model "
                            f"{model_state['model_id'] or '(adopting)'!r}"
                            f"; adoption is a warm-pool-only "
                            f"transition"})
            return
        model_state["adopting"] = True
        if args.tiny:
            _, new_params = jr.tiny_model(seed)
        else:
            _, new_params = jr.flagship_model(seed,
                                              max_len=args.max_len or 1024)

        def applied():
            model_state["model_id"] = model_id
            model_state["warm_pool"] = False
            model_state["adopting"] = False
            reply({"op": "adopted", "id": mid, "model_id": model_id})

        batcher.set_weights(
            new_params,
            version=f"{args.weights_version or 'v0'}@{model_id}",
            on_applied=applied)

    def self_addr():
        return cell[0].addr if cell else ""

    serving = None
    if args.role == "prefill":
        handler = jr.prefill_handler(batcher, token=token,
                                     self_addr=self_addr)
    else:
        serving = jr.BatcherServing(batcher)
        handler = jr.batcher_handler(serving, generation=generation,
                                     weights_version=args.weights_version,
                                     model_state=model_state,
                                     adopt_fn=adopt_fn, token=token,
                                     self_addr=self_addr)
    if fabric is not None:              # fleet/replica.py:1530-1533
        handler = jr.fabric_handler(fabric, handler)

    def extra():        # fleet/replica.py:1535-1583, for these builds
        beat = {"role": args.role, "kv_headroom": batcher.kv_headroom(),
                "gen": generation}
        if args.weights_version:
            beat["weights_version"] = args.weights_version
        if node:
            beat["node"] = node
        if model_state["model_id"]:
            beat["model_id"] = model_state["model_id"]
        if model_state["pool_capable"]:
            beat["warm_pool"] = bool(model_state["warm_pool"])
        beat["adapter_version"] = getattr(batcher, "adapter_version", "")
        if batcher.prefix_cache_active:
            beat["prefix_cache"] = batcher.prefix_cache_summary()
        if tiered:
            beat["kv_tier"] = batcher.kv_tier.summary()
        if batcher.d_side is not None:
            beat["spec"] = {"acceptance_rate": batcher.acceptance_rate,
                            "rounds": batcher.spec_rounds,
                            "row_rounds": batcher.spec_row_rounds,
                            "committed": batcher.spec_committed,
                            "n_draft": batcher.n_draft}
        return beat

    server = jr.ReplicaServer(
        handler, token=token, capacity=args.rows, host=args.host,
        port=args.port, registry_addr=args.registry,
        heartbeat_interval=args.heartbeat_interval, extra_info=extra,
        status="warming" if args.warmup else None)
    cell.append(server)
    server.start()
    if fabric is not None:              # fleet/replica.py:1597-1598
        fabric.self_addr = server.addr or ""
    if args.warmup:
        batcher.warmup(decode=args.role != "prefill",
                       prefill=args.role != "decode")
    if serving is not None:
        serving.start()
    server.set_status(None)
    return server, serving, batcher


def port_replica(argv, token: str, params=None, environ=None,
                 draft_params=None):
    """The port's replica in this process through its own
    ``start_replica`` (``--device cpu`` appended)."""
    from tfmesos_tpu_torch.fleet import replica as pr

    args = pr.build_parser().parse_args(list(argv) + ["--device", "cpu"])
    environ = replica_environ() if environ is None else environ
    return pr.start_replica(args, token=token, params=params,
                            environ=environ, draft_params=draft_params)


def tiny_draft_params(max_len: int = 128, n_draft: int = 4):
    """The JAX replica's tiny draft (``tiny_draft_model``: its default
    seed) carried across to the port: (JAX config, JAX params, port
    params)."""
    import jax

    from tfmesos_tpu.fleet.replica import tiny_draft_model
    from tfmesos_tpu_torch import convert

    dcfg, dparams = tiny_draft_model(max_len=max_len, n_draft=n_draft)
    return dcfg, dparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, dparams))


def stop_replica(replica) -> None:
    server, serving, _ = replica
    server.stop()
    if serving is not None:
        serving.close()


def wait_for(cond, timeout: float = 20.0, what: str = "condition"):
    """Poll ``cond()`` until it is truthy; returns its value."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


class JaxFleet:
    """The JAX registry, router and gateway in this process (the pattern
    of ``tests/test_disagg.py:390-464``); replicas register themselves.
    ``client()`` dials the gateway with ``FleetClient``.  ``side="port"``
    builds the same from the port's ``tfmesos_tpu_torch.fleet``."""

    def __init__(self, token: str, workers: int = 8, side: str = "jax"):
        if side == "jax":
            from tfmesos_tpu.fleet import (admission, client, gateway,
                                           metrics, registry, router)
        else:
            from tfmesos_tpu_torch.fleet import (admission, client,
                                                 gateway, metrics,
                                                 registry, router)
        self._client_mod = client
        self.token = token
        self.registry = registry.ReplicaRegistry(
            token=token, suspect_after=5.0, dead_after=10.0,
            sweep_interval=0.05).start()
        self.metrics = metrics.FleetMetrics()
        self.router = router.Router(self.registry, self.metrics,
                                    token=token, request_timeout=120.0)
        self.gateway = gateway.Gateway(
            self.router, admission.AdmissionController(max_queue=64),
            self.metrics, token=token, workers=workers).start()
        self._clients = []

    @property
    def addr(self) -> str:
        return self.registry.addr

    def info(self, addr: str):
        for r in self.registry.members():
            if r.addr == addr:
                return r
        return None

    def wait_routable(self, *addrs) -> None:
        wait_for(lambda: set(addrs) <= {r.addr for r in
                                        self.registry.alive()},
                 what=f"{addrs} routable")

    def client(self, client_mod=None):
        """A ``FleetClient`` on the gateway: this side's, or the one of
        ``client_mod`` (the other package's ``fleet.client``)."""
        mod = client_mod if client_mod is not None else self._client_mod
        c = mod.FleetClient(self.gateway.addr, self.token, timeout=120.0)
        self._clients.append(c)
        return c

    def close(self) -> None:
        for c in self._clients:
            c.close()
        self.gateway.stop()
        self.registry.stop()


def offline_generate(jcfg, jparams, prompts, new_tokens: int) -> list:
    """The JAX package's offline greedy ``generate`` of each prompt (one
    ragged batch, one compile): the continuation lists."""
    import jax.numpy as jnp

    from tfmesos_tpu.models import transformer as jt

    lens = [len(p) for p in prompts]
    batch = np.zeros((len(prompts), max(lens)), np.int32)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    out = np.asarray(jt.generate(jcfg, jparams, jnp.asarray(batch),
                                 new_tokens,
                                 prompt_lens=jnp.asarray(lens, jnp.int32)))
    return [out[i, n:n + new_tokens].tolist() for i, n in enumerate(lens)]


def slow_streams(server, delay: float):
    """Make ``server``'s streamed requests flush each tick's partial
    frame ``delay`` seconds late (the batcher's serve thread sends the
    partials, so its ticks slow down): a request stays in flight long
    enough for a ``migrate`` or a ``cancel`` to land mid-stream.
    Returns the handler to put back."""
    import time

    inner = server.handler

    def handler(msg, reply):
        send = reply.partial

        def slow(out):
            time.sleep(delay)
            send(out)

        reply.partial = slow
        inner(msg, reply)

    server.handler = handler
    return inner
