"""repro_torch.deploy — one declarative deployment API: MiniConvSpec ->
served policy, on the GPU (port of ``repro.deploy``).

* :class:`DeploymentConfig` — the frozen, JSON-serialisable manifest, with
  the reference's schema and ``CONFIG_VERSION = 2``; manifests of
  versions 1 and 2 written by ``repro.deploy`` load here unchanged.
* :class:`Deployment` — the compiled form.  ``Deployment.build(config)``
  resolves the config ONCE into the budget-checked PassPlan, the
  parameter initialiser, the :class:`SplitModel`, the RL-facing
  :class:`~repro_torch.rl.networks.Encoder`, the codec, and factories for a
  ready ``EdgeClient`` / ``BatchingPolicyServer`` pair.

Quick start::

    import torch
    from repro_torch.deploy import Deployment, DeploymentConfig

    cfg = DeploymentConfig.standard(k=4, c_in=12, h=84, backend="fused")
    dep = Deployment.build(cfg)                 # device="cuda" by default
    params = dep.init(torch.Generator().manual_seed(0))
    client, server = dep.serving_pair(params)
    actions = server.serve([client.encode_fn(obs)])

Run ``python -m repro_torch.deploy --verify`` to write and round-trip-
verify a manifest, ``--tune`` to measure every backend on the device
(``core.tuning``) and freeze the winner into it, and ``--scenario NAME`` to
run the manifest through a registered serving scenario, and
``--real-fleet`` to serve it from ``n_servers`` spawned worker processes
over localhost sockets, bitwise equal to in-process serving.  The
manifest's fleet shape (``n_servers``, ``router``) drives
:meth:`Deployment.fleet_sim`, :meth:`Deployment.scenario_sim` and the real
:meth:`Deployment.fleet`.  Training is ported (``repro_torch.rl.train``;
its ``TrainResult.params`` serve through :meth:`Deployment.serving_pair`),
and so are populations: :meth:`Deployment.export_best` serves a
``PopulationResult``'s winner.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, Optional

import torch

from repro_torch.core.backends import (ExecutionBackend, backend_names,
                                       get_backend)
from repro_torch.core.miniconv import (_ACTS, LayerSpec, MiniConvSpec,
                                       ShaderBudget, miniconv_apply,
                                       standard_spec)
from repro_torch.core.passplan import HeadPlan, PassPlan, build_pass_plan
from repro_torch.core.split import SplitModel
from repro_torch.core.tuning import TunedPlan
from repro_torch.core.wire import CODECS, WireCodec, get_codec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.layers import dense
from repro_torch.rl.networks import Encoder, miniconv_encoder_init
from repro_torch.schema import check_version
from repro_torch.serving.client import EdgeClient
from repro_torch.serving.fleet import ROUTERS, FleetQueueSim
from repro_torch.serving.server import BatchingPolicyServer

# version 2 added the optional ``tuning`` block (a frozen TunedPlan);
# version-1 manifests load unchanged with ``tuning=None``.
CONFIG_VERSION = 2
_READABLE_VERSIONS = (1, 2)


# ---------------------------------------------------------------------------
# The manifest
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeploymentConfig:
    """Declarative, serialisable description of one split-policy deployment.

    The fields are the reference's (``repro.deploy.DeploymentConfig``):

    spec            : the MiniConv encoder architecture (budget-checked).
    in_h, in_w      : the concrete input size the edge device sees.
    backend         : execution-backend name (``core.backends``).
    interpret       : the reference's Pallas interpret switch.  Accepted so
                      that manifests load; it means nothing to the port.
    codec           : wire-codec name (``core.wire.CODECS``).
    head_dim        : width of the server-side projection (paper: 512).
    head_act        : activation of the projection.
    head_placement  : ``"server"`` (the paper's split) or ``"fused"``
                      (projection fused with the encoder into one call).
    max_batch       : server micro-batching cap (B frames per launch).
    max_wait_ms     : how long the server holds a batch open.
    tile_h          : the reference's output-row tile; the CUDA kernel has
                      no row tiles, so it does not change the result.
    quantize_in_train : straight-through-quantise features in training.
    n_servers       : fleet size: how many micro-batching servers share
                      the ingress (1 = the paper's Table 6 single server).
    router          : fleet routing policy (``serving.fleet.ROUTERS``).
    tuning          : optional frozen :class:`TunedPlan`, honoured only
                      when the port measured it (see :meth:`Deployment.build`).
    """

    spec: MiniConvSpec
    in_h: int
    in_w: int
    backend: str = "fused"
    interpret: Optional[bool] = None
    codec: str = "uint8"
    head_dim: int = 512
    head_act: str = "relu"
    head_placement: str = "server"
    max_batch: int = 8
    max_wait_ms: float = 0.0
    tile_h: int = 8
    quantize_in_train: bool = False
    n_servers: int = 1
    router: str = "round_robin"
    tuning: Optional[TunedPlan] = None

    def __post_init__(self):
        # canonicalise backend aliases (and the legacy use_kernel booleans)
        # so equality and serialisation are name-stable
        object.__setattr__(self, "backend", get_backend(self.backend).name)
        if isinstance(self.tuning, dict):     # deserialised manifests
            object.__setattr__(self, "tuning",
                               TunedPlan.from_dict(self.tuning))

    # ---- construction helpers ---------------------------------------------
    @classmethod
    def standard(cls, *, k: int = 4, c_in: int = 12, h: int = 84,
                 w: Optional[int] = None, **overrides) -> "DeploymentConfig":
        """The paper's standard encoder family, deployed at (h, w)."""
        return cls(spec=standard_spec(c_in=c_in, k=k), in_h=h,
                   in_w=h if w is None else w, **overrides)

    @classmethod
    def from_encoder_name(cls, name: str, *, c_in: int, h: int = 84,
                          w: Optional[int] = None,
                          **overrides) -> "DeploymentConfig":
        """``miniconv<K>``."""
        if not name.startswith("miniconv"):
            raise ValueError(f"not a MiniConv deployment: {name!r} "
                             f"(full_cnn has no split pipeline)")
        k = int(name.replace("miniconv", ""))
        return cls.standard(k=k, c_in=c_in, h=h, w=w, **overrides)

    # ---- validation --------------------------------------------------------
    def validate(self) -> None:
        get_backend(self.backend)          # raises listing registered names
        if self.codec not in CODECS:
            raise ValueError(f"unknown codec {self.codec!r}; registered: "
                             f"{', '.join(CODECS)}")
        if self.head_placement not in ("server", "fused"):
            raise ValueError(f"head_placement must be 'server' or 'fused', "
                             f"got {self.head_placement!r}")
        if self.head_act not in _ACTS:
            raise ValueError(f"unknown head_act {self.head_act!r}; one of "
                             f"{', '.join(_ACTS)}")
        if self.in_h < 1 or self.in_w < 1:
            raise ValueError(f"input size must be positive, got "
                             f"{(self.in_h, self.in_w)}")
        if self.head_dim < 1:
            raise ValueError(f"head_dim must be positive: {self.head_dim}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0: {self.max_wait_ms}")
        if self.tile_h < 1:
            raise ValueError(f"tile_h must be >= 1: {self.tile_h}")
        if self.n_servers < 1:
            raise ValueError(f"n_servers must be >= 1: {self.n_servers}")
        if self.router not in ROUTERS:
            raise ValueError(f"unknown router {self.router!r}; registered: "
                             f"{', '.join(ROUTERS)}")
        if self.tuning is not None:
            get_backend(self.tuning.backend)   # raises listing names
            if self.tuning.tile_h < 1 or self.tuning.micro_batch < 1:
                raise ValueError(
                    f"tuning tile_h/micro_batch must be >= 1, got "
                    f"{self.tuning.tile_h}/{self.tuning.micro_batch}")
        self.spec.validate()

    # ---- serialisation -----------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-safe manifest; inverse of :meth:`from_dict`."""
        d = dataclasses.asdict(self)
        d["spec"] = {
            "layers": [dataclasses.asdict(l) for l in self.spec.layers],
            "budget": dataclasses.asdict(self.spec.budget),
        }
        d["tuning"] = None if self.tuning is None else self.tuning.to_dict()
        d["version"] = CONFIG_VERSION
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DeploymentConfig":
        d = dict(d)
        check_version("DeploymentConfig manifest",
                      d.pop("version", CONFIG_VERSION), _READABLE_VERSIONS)
        s = d.pop("spec")
        spec = MiniConvSpec(
            layers=tuple(LayerSpec(**l) for l in s["layers"]),
            budget=ShaderBudget(**s.get("budget", {})))
        return cls(spec=spec, **d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "DeploymentConfig":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# The compiled deployment
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Deployment:
    """A resolved deployment: every pipeline stage, built once from config.

    Construct with :meth:`build`.  Parameters stay OUTSIDE (plain dicts of
    tensors on ``device``), so one Deployment serves several parameter
    sets.
    """

    config: DeploymentConfig
    backend: ExecutionBackend
    plan: PassPlan
    head_plan: HeadPlan
    codec: WireCodec
    split: SplitModel
    encoder: Encoder
    max_safe_batch: int
    device: torch.device
    tile_h: int = 8
    stream_chunk: Optional[int] = None
    build_log: tuple = ()

    # ---- the compiler ------------------------------------------------------
    @classmethod
    def build(cls, config: DeploymentConfig,
              device: DeviceLike = None) -> "Deployment":
        """Resolve ``config`` into the executable pipeline on ``device``
        (``"cuda"`` by default; ``"cpu"`` runs the kernels' plain versions).

        The PassPlan is lowered and budget-checked once, up front.  A
        manifest ``tuning`` block overrides the backend, ``tile_h`` and the
        stream chunk (its ``micro_batch``) only when its ``mode`` is one
        the port stamps; a block measured by the reference is recorded in
        ``build_log`` and the config's own fields apply.  For the fused
        backends the plan decides how the kernels cut a batch into halo
        tiles (every intermediate in shared memory), and ``fused+stream``,
        or plain ``fused`` at a ``max_batch`` past ``max_safe_batch``,
        streams the batch through the persistent kernel with
        ``stream_chunk`` frames in flight; ``build_log`` records both
        decisions and, when it streams, the persistent kernel's plan (tile,
        frames a layer pass, its input buffer).
        """
        config.validate()
        dev = resolve_device(device)
        backend = get_backend(config.backend)
        tile_h = config.tile_h
        tuning = config.tuning
        log: list[str] = []
        if tuning is not None and tuning.measured_by_port:
            backend = get_backend(tuning.backend)
            tile_h = tuning.tile_h
            log.append(
                f"tuning: manifest TunedPlan -> backend={backend.name} "
                f"tile_h={tile_h} micro_batch={tuning.micro_batch} "
                f"(measured {tuning.mode} on {tuning.host or 'unknown'})")
        elif tuning is not None:
            log.append(
                f"tuning: block measured elsewhere ({tuning.mode} on "
                f"{tuning.host or 'unknown'}), not by this port; ignored — "
                f"backend={backend.name} tile_h={tile_h} from the config")
            tuning = None
        spec = config.spec
        plan = build_pass_plan(spec, config.in_h, config.in_w)
        head_plan = plan.head(config.head_dim, activation=config.head_act)
        max_safe = plan.max_safe_batch()
        stream_chunk: Optional[int] = None
        if backend.mode == "fused":
            tiles = plan.tile_plan(config.max_batch)
            log.append(
                f"staging: halo tiles of {tiles.tile_h}x{tiles.tile_w} "
                f"outputs, {tiles.n_tiles} a frame at max_batch="
                f"{config.max_batch}; every layer's region in the block's "
                f"shared memory ({tiles.smem_bytes} B a block, "
                f"{plan.tile_plan(config.max_batch, streamed=True).smem_bytes}"
                f" B streamed); no intermediate reaches device memory")
            if backend.streamed:
                chunk = (min(tuning.micro_batch, max_safe)
                         if tuning is not None else max_safe)
                stream_chunk = max(1, min(chunk, config.max_batch))
                log.append(f"streaming: {backend.name} in {stream_chunk}-"
                           f"frame chunks (max_safe_batch {max_safe})")
            elif config.max_batch > max_safe:
                stream_chunk = max_safe
                log.append(
                    f"streaming: max_batch {config.max_batch} > "
                    f"max_safe_batch {max_safe}, the frames that fill one "
                    f"wave of resident blocks; batches past {max_safe} "
                    f"frames stream through the persistent kernel, which "
                    f"fetches each block's next tile while it computes, "
                    f"{max_safe} frames in flight")
            if stream_chunk is not None:
                k4 = plan.tile_plan(config.max_batch, streamed=True)
                log.append(
                    f"stream plan: K4 tiles of {k4.tile_h}x{k4.tile_w}, "
                    f"{k4.frames} frame(s) a layer pass, 1 input buffer "
                    f"refilled after the first layer, {k4.smem_bytes} B a "
                    f"block, {k4.blocks_per_sm} blocks an SM at max_batch="
                    f"{config.max_batch}")
        codec = get_codec(config.codec)
        mode = backend.mode
        head_act = config.head_act

        def edge_apply(edge_params, obs):
            return miniconv_apply(edge_params, spec, obs, use_kernel=mode,
                                  plan=plan if mode == "fused" else None,
                                  tile_h=tile_h, stream_chunk=stream_chunk)

        def server_apply(server_params, feats):
            z = dense(server_params["proj"], feats.reshape(feats.shape[0], -1))
            return _ACTS[head_act](z)

        split = SplitModel(edge_apply=edge_apply, server_apply=server_apply,
                           codec=codec,
                           quantize_in_train=config.quantize_in_train,
                           plan=plan)

        def init(gen):
            return miniconv_encoder_init(gen, spec, h=config.in_h,
                                         w=config.in_w,
                                         feature_dim=config.head_dim,
                                         device=dev)

        def deployed_plan(obs):
            # training tolerates other input sizes: re-lower then
            return plan if (mode == "fused"
                            and tuple(obs.shape[1:3]) == (plan.in_h,
                                                          plan.in_w)) else None

        if config.head_placement == "fused" or backend.fused_head:
            def encoder_apply(params, obs):
                # encoder + projection in one call (one kernel launch
                # under the fused backends)
                p = deployed_plan(obs)
                _, z = miniconv_apply(params["edge"], spec, obs,
                                      use_kernel=mode, plan=p, tile_h=tile_h,
                                      head=params["server"]["proj"],
                                      head_act=head_act,
                                      stream_chunk=stream_chunk
                                      if p is not None else None)
                return z
        else:
            def encoder_apply(params, obs):
                p = deployed_plan(obs)
                feats = miniconv_apply(params["edge"], spec, obs,
                                       use_kernel=mode, plan=p, tile_h=tile_h,
                                       stream_chunk=stream_chunk
                                       if p is not None else None)
                return server_apply(params["server"], feats)

        encoder = Encoder(name=f"miniconv{spec.k_out}", init=init,
                          apply=encoder_apply, spec=spec)
        return cls(config=config, backend=backend, plan=plan,
                   head_plan=head_plan, codec=codec, split=split,
                   encoder=encoder, max_safe_batch=max_safe, device=dev,
                   tile_h=tile_h, stream_chunk=stream_chunk,
                   build_log=tuple(log))

    # ---- parameters --------------------------------------------------------
    def init(self, gen: torch.Generator):
        """{"edge": conv params, "server": {"proj": dense}} on
        ``self.device`` — the dict split IS the deployment split."""
        return self.encoder.init(gen)

    # ---- accounting --------------------------------------------------------
    @property
    def spec(self) -> MiniConvSpec:
        return self.config.spec

    @property
    def wire_bytes(self) -> int:
        """Exact bytes of one request's payload on the link."""
        return self.split.wire_bytes()

    def wire_bytes_batch(self, batch: Optional[int] = None) -> int:
        return self.split.wire_bytes(
            batch=self.config.max_batch if batch is None else batch)

    @property
    def frame_bytes(self) -> int:
        """Bytes of the raw observation upload the server-only baseline
        transmits (RGBA-packed: 4 channels per texture)."""
        c = self.spec.layers[0].c_in
        return self.config.in_h * self.config.in_w * (-(-c // 4) * 4)

    # ---- served pipeline ---------------------------------------------------
    @staticmethod
    def _split_params(params):
        """Accept either the encoder split ({"edge", "server"}) or a full
        trained parameter tree whose ``"encoder"`` entry is that split."""
        if "edge" not in params and "encoder" in params:
            return params["encoder"]
        return params

    def edge_fn(self, params) -> Callable:
        """On-device half: obs -> wire payload."""
        edge_params = self._split_params(params)["edge"]

        def fn(obs):
            with torch.inference_mode():
                return self.split.edge_step(edge_params, obs)
        return fn

    def server_fn(self, params, head: Optional[Callable] = None) -> Callable:
        """Remote half: payload -> features (or actions via ``head``, e.g.
        a policy MLP applied after the projection)."""
        server_params = self._split_params(params)["server"]

        def fn(payload):
            with torch.inference_mode():
                z = self.split.server_step(server_params, payload)
                return head(z) if head is not None else z
        return fn

    def server_batch_fn(self, params,
                        head: Optional[Callable] = None) -> Callable:
        """Micro-batched remote half: stacked payload -> actions."""
        server_params = self._split_params(params)["server"]

        def fn(payload_batch):
            with torch.inference_mode():
                z = self.split.server_step_batch(server_params,
                                                 payload_batch)
                return head(z) if head is not None else z
        return fn

    def client(self, params) -> EdgeClient:
        """Ready :class:`EdgeClient` for these parameters."""
        return EdgeClient(encode_fn=self.edge_fn(params),
                          wire_bytes=self.wire_bytes)

    def server(self, params,
               head: Optional[Callable] = None) -> BatchingPolicyServer:
        """Ready :class:`BatchingPolicyServer` under this config's
        batching policy (``max_batch`` / ``max_wait_ms``)."""
        return BatchingPolicyServer(
            serve_batch_fn=self.server_batch_fn(params, head),
            max_batch=self.config.max_batch,
            max_wait_s=self.config.max_wait_ms / 1e3)

    def serving_pair(self, params, head: Optional[Callable] = None
                     ) -> tuple[EdgeClient, BatchingPolicyServer]:
        """The paper's Figure-5 pipeline, ready to measure."""
        return self.client(params), self.server(params, head)

    def export_best(self, population, head: Optional[Callable] = None
                    ) -> tuple[EdgeClient, BatchingPolicyServer]:
        """Serving pair for a population run's winning member.

        ``population`` is a
        :class:`repro_torch.rl.population.PopulationResult`; the winner is
        its ``best_member()`` — highest ``final_100_mean`` under the
        deterministic eval protocol.  The member's trained params serve
        through THIS manifest exactly like the single-run path
        (:meth:`serving_pair` accepts ``TrainState.params`` directly), so
        train-many / freeze-best / serve-on-fleet is one manifest
        round-trip.
        """
        return self.serving_pair(population.best_params(), head=head)

    def fleet_sim(self, service_model: Callable[[int], float], *, uplink,
                  rate_hz: float = 10.0, horizon_s: float = 5.0,
                  action_bytes: int = 64,
                  n_servers: Optional[int] = None,
                  router: Optional[str] = None,
                  max_batch: Optional[int] = None,
                  max_wait_s: Optional[float] = None) -> FleetQueueSim:
        """Fleet-scale queue simulator for THIS deployment.

        Payload bytes, micro-batching policy and fleet shape
        (``n_servers`` / ``router``) all come from the manifest; keyword
        overrides take precedence, so a benchmark sweeping the batching
        policy keeps the sim on the policy it MEASURED t(B) under.
        ``service_model`` is that measured curve
        (``BatchingPolicyServer.service_model()``), charged by every
        server.  At ``n_servers=1`` this is the Table 6 batched
        simulation.
        """
        cfg = self.config
        return FleetQueueSim(
            service_time_s=service_model(1), uplink=uplink,
            payload_bytes=self.wire_bytes, action_bytes=action_bytes,
            rate_hz=rate_hz, horizon_s=horizon_s,
            max_batch=cfg.max_batch if max_batch is None else max_batch,
            max_wait_s=cfg.max_wait_ms / 1e3 if max_wait_s is None
            else max_wait_s,
            service_model=service_model,
            n_servers=cfg.n_servers if n_servers is None else n_servers,
            router=cfg.router if router is None else router)

    def scenario_sim(self, scenario, *,
                     n_servers: Optional[int] = None,
                     router: Optional[str] = None,
                     max_batch: Optional[int] = None,
                     max_wait_s: Optional[float] = None,
                     adaptation: str = "none",
                     service_model: Optional[Callable[[int], float]] = None):
        """This deployment under a named (or inline) :class:`Scenario`.

        The scenario supplies the serving condition (its seeded link, its
        device zoo cycled across the servers, client population and rate,
        adaptation-mode ladder); the manifest supplies the deployment:
        payload bytes (``wire_bytes``), micro-batching policy and fleet
        shape, with the keyword-override precedence of :meth:`fleet_sim`.
        ``adaptation`` picks the controller (``"none"``, ``"rule"``,
        ``"static:<i>"`` or a registered one); a measured
        ``service_model`` replaces the zoo on every server.  Returns a
        :class:`~repro_torch.serving.scenario.ScenarioFleetSim`; call
        ``.report(n_clients)``.
        """
        from repro_torch.serving.scenario import get_scenario
        sc = get_scenario(scenario)
        cfg = self.config
        ns = cfg.n_servers if n_servers is None else n_servers
        return sc.sim(
            self.wire_bytes, n_servers=ns,
            router=cfg.router if router is None else router,
            max_batch=cfg.max_batch if max_batch is None else max_batch,
            max_wait_s=cfg.max_wait_ms / 1e3 if max_wait_s is None
            else max_wait_s,
            adaptation=adaptation,
            service_models=None if service_model is None
            else (service_model,) * ns)

    def fleet(self, params, *, n_servers: Optional[int] = None,
              router: Optional[str] = None, max_batch: Optional[int] = None,
              service_model: Optional[Callable[[int], float]] = None,
              timeout_s: float = 10.0, retries: int = 2,
              precompile: bool = True, start: bool = True,
              shaping=None):
        """A REAL multi-process fleet for THIS deployment (localhost).

        The counterpart of :meth:`fleet_sim`: ``n_servers`` spawned worker
        processes, each rebuilding the server half from this manifest on
        this deployment's device, length-prefix-framed sockets carrying
        the wire codec's payloads, and the registered routing policy at
        the front door (``repro_torch.serving.realfleet``).  The fleet
        shape defaults to the manifest's (``n_servers`` / ``router`` /
        ``max_batch``), as in the simulator.  The parameters cross the
        process boundary as numpy arrays.

        With a measured ``service_model``, worker admission is capped at
        its ``max_measured_batch``: the real fleet never serves batch
        sizes the t(B) curve only extrapolates.  ``shaping`` (a
        :class:`~repro_torch.serving.realfleet.ShapingConfig` or its dict)
        token-bucket-shapes every worker's request ingress.

        Returns a started :class:`~repro_torch.serving.realfleet.RealFleet`
        (``start=False`` defers the spawn); always ``close()`` it: the
        returned leak list is the "no leaked workers" gate.
        """
        from repro_torch.nn.module import tree_map
        from repro_torch.serving.realfleet import RealFleet
        cfg = self.config
        cap = cfg.max_batch if max_batch is None else max_batch
        if service_model is not None and hasattr(service_model,
                                                 "max_measured_batch"):
            cap = min(cap, service_model.max_measured_batch)
        params_np = tree_map(lambda t: t.detach().cpu().numpy(),
                             self._split_params(params))
        fl = RealFleet(
            cfg.to_dict(), params_np,
            n_servers=cfg.n_servers if n_servers is None else n_servers,
            router=cfg.router if router is None else router,
            max_batch=max(1, cap), timeout_s=timeout_s, retries=retries,
            precompile=precompile, shaping=shaping, device=str(self.device))
        return fl.start() if start else fl


# ---------------------------------------------------------------------------
# Manifest CLI: python -m repro_torch.deploy
# ---------------------------------------------------------------------------

def _verify_roundtrip(cfg: DeploymentConfig, *, device: DeviceLike = None,
                      seed: int = 0) -> None:
    """Raise unless a reloaded manifest gives identical encoder outputs and
    wire payloads."""
    cfg2 = DeploymentConfig.from_json(cfg.to_json())
    if cfg2 != cfg:
        raise AssertionError("manifest round-trip changed the config")
    dep = Deployment.build(cfg, device=device)
    dep2 = Deployment.build(cfg2, device=device)
    params = dep.init(torch.Generator().manual_seed(seed))
    params2 = dep2.init(torch.Generator().manual_seed(seed))
    obs = torch.rand((1, cfg.in_h, cfg.in_w, cfg.spec.layers[0].c_in),
                     generator=torch.Generator().manual_seed(seed + 1))
    obs = obs.to(dep.device)
    with torch.inference_mode():
        if not torch.equal(dep.encoder.apply(params, obs),
                           dep2.encoder.apply(params2, obs)):
            raise AssertionError("reloaded manifest changed encoder outputs")
    p1 = dep.edge_fn(params)(obs)
    p2 = dep2.edge_fn(params2)(obs)
    for k in p1:
        if not torch.equal(p1[k], p2[k]):
            raise AssertionError(f"reloaded manifest changed payload {k!r}")


def _real_fleet_check(cfg: DeploymentConfig, *, n_requests: int = 8,
                      seed: int = 0, device: DeviceLike = None) -> dict:
    """Launch the manifest's real multi-process fleet on localhost, serve
    ``n_requests`` over sockets through the manifest's router and then
    every other registered router, and raise unless every action is
    bitwise equal to in-process ``server.serve([p])`` on the same device.
    With ``n_servers > 1`` it then kills worker 0 and serves them again
    round-robin: the dead worker's requests re-route and stay bitwise
    equal.  It raises unless every worker served a request (when
    ``n_requests >= n_servers``) and no worker leaked at shutdown.
    Requests go one at a time, so every worker serves a batch of one, as
    the in-process server does.  Returns what it saw."""
    import numpy as np
    from repro_torch.serving.fleet import router_names
    dep = Deployment.build(cfg, device=device)
    params = dep.init(torch.Generator().manual_seed(seed))
    client, server = dep.serving_pair(params)
    obs = torch.rand((n_requests, cfg.in_h, cfg.in_w,
                      cfg.spec.layers[0].c_in),
                     generator=torch.Generator().manual_seed(seed + 1))
    obs = obs.to(dep.device)
    payloads = [client.encode_fn(obs[i:i + 1]) for i in range(n_requests)]
    want = [server.serve([p])[0].cpu().numpy() for p in payloads]

    def serve_all(what):
        got = [fleet.request(p, client=i) for i, p in enumerate(payloads)]
        for i, (w, g) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(
                w, g, err_msg=f"request {i} {what}: socket-served action "
                              f"differs from in-process serving")

    routers = [cfg.router] + [r for r in router_names() if r != cfg.router]
    killed = None
    fleet = dep.fleet(params)
    try:
        for router in routers:
            fleet.set_router(router)
            serve_all(f"via {router}")
        per_server = list(fleet.stats["per_server"])
        if cfg.n_servers > 1:
            killed = fleet.processes[0].pid
            fleet.processes[0].kill()
            fleet.processes[0].join(10.0)
            fleet.set_router("round_robin")
            serve_all(f"after killing worker 0 (pid {killed})")
        stats = dict(fleet.stats, per_server=list(fleet.stats["per_server"]))
    finally:
        leaked = fleet.close()
    if leaked:
        raise AssertionError(f"leaked worker processes: {leaked}")
    if n_requests >= cfg.n_servers and min(per_server) == 0:
        raise AssertionError(f"a worker served no request: per-server "
                             f"{per_server}")
    after = [b - a for a, b in zip(per_server, stats["per_server"])]
    print(f"  real fleet: {cfg.n_servers} worker(s) on {dep.device} served "
          f"{n_requests} requests over sockets through each of "
          f"{', '.join(routers)} (per-server {per_server}); actions "
          f"bitwise equal to in-process serving")
    if killed is not None:
        print(f"  real fleet: worker 0 (pid {killed}) killed; {n_requests} "
              f"requests re-routed (per-server {after}, {stats['retries']} "
              f"retries), bitwise equal")
    print(f"  real fleet: clean shutdown, no leaked workers (started in "
          f"{fleet.startup_s:.2f} s, drained and joined in "
          f"{fleet.close_s:.2f} s)")
    return {"n_servers": cfg.n_servers, "device": str(dep.device),
            "startup_s": fleet.startup_s, "close_s": fleet.close_s,
            "n_requests": n_requests, "routers": routers,
            "per_server": per_server, "killed_pid": killed,
            "per_server_after_kill": after if killed is not None else None,
            "retries": stats["retries"], "bitwise": True,
            "leaked": leaked}


def _scenario_report(dep: "Deployment", name: str) -> None:
    """Run one registered scenario against this deployment and print the
    static-against-adaptive scorecard (simulation only)."""
    from repro_torch.serving.scenario import get_scenario
    sc = get_scenario(name)
    print(f"  scenario {sc.name}: link={sc.link_kind} seed={sc.seed} "
          f"devices={','.join(sc.devices)} N={sc.n_clients} "
          f"rate={sc.rate_hz}Hz horizon={sc.horizon_s}s "
          f"deadline={sc.deadline_s * 1e3:.0f}ms")
    policies = ([f"static:{i}" for i in range(len(sc.modes))]
                + (["rule"] if len(sc.modes) > 1 else []))
    for adapt in policies:
        rep = dep.scenario_sim(sc, adaptation=adapt).report(sc.n_clients)
        modes = " ".join(f"{k}={v}" for k, v in rep.mode_counts().items()
                         if v)
        print(f"    {adapt:<9} p95={rep.p95_s * 1e3:8.2f}ms "
              f"mean={rep.mean_s * 1e3:7.2f}ms "
              f"return={rep.delivered_return:.4f} "
              f"bytes={rep.total_uplink_bytes / 1e6:.3f}MB  [{modes}]")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Build the standard deployment config, write its "
                    "manifest, reload it and verify the round-trip.")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--c-in", type=int, default=12)
    ap.add_argument("--x", type=int, default=84, help="input H=W")
    ap.add_argument("--backend", default="fused",
                    help=f"one of: {', '.join(backend_names())}")
    ap.add_argument("--codec", default="uint8")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--n-servers", type=int, default=1,
                    help="fleet size for the sharded serving simulation")
    ap.add_argument("--router", default="round_robin",
                    help=f"fleet routing policy: {', '.join(ROUTERS)}")
    ap.add_argument("--out", default="deploy_manifest.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--verify", action="store_true",
                    help="rebuild from the reloaded manifest and assert "
                         "identical encoder outputs and wire payloads")
    ap.add_argument("--tune", action="store_true",
                    help="autotune backend/tile_h/micro-batch for this "
                         "config on --device (core.tuning) and freeze the "
                         "winning TunedPlan into the written manifest")
    ap.add_argument("--tune-iters", type=int, default=5,
                    help="timing repetitions per measured candidate")
    ap.add_argument("--real-fleet", action="store_true",
                    help="launch the manifest's REAL multi-process fleet "
                         "on localhost (n_servers worker processes on "
                         "--device behind the configured router), verify "
                         "socket-served actions are bitwise equal to "
                         "in-process serving, and shut down cleanly")
    ap.add_argument("--fleet-requests", type=int, default=8,
                    help="requests served during the --real-fleet check")
    ap.add_argument("--scenario", default=None,
                    help="run the manifest through a registered serving "
                         "scenario (repro_torch.serving.scenario: seeded "
                         "link + device zoo) and print the per-static-mode "
                         "and rule-controller comparison")
    args = ap.parse_args(argv)

    cfg = DeploymentConfig.standard(k=args.k, c_in=args.c_in, h=args.x,
                                    backend=args.backend, codec=args.codec,
                                    max_batch=args.max_batch,
                                    n_servers=args.n_servers,
                                    router=args.router)
    if args.tune:
        from repro_torch.core.tuning import tune
        print(f"  tuning {args.backend} X={args.x} "
              f"max_batch={args.max_batch} on {args.device} ...")
        tp = tune(cfg, iters=args.tune_iters, log=print, device=args.device)
        cfg = dataclasses.replace(cfg, tuning=tp)
        print(f"  tuned: backend={tp.backend} tile_h={tp.tile_h} "
              f"micro_batch={tp.micro_batch} "
              f"({tp.per_frame_s * 1e6:.1f} us/frame, mode={tp.mode}, "
              f"searched={tp.searched} pruned={tp.pruned})")
    dep = Deployment.build(cfg, device=args.device)
    for line in dep.build_log:
        print(f"  {line}")
    with open(args.out, "w") as f:
        f.write(cfg.to_json(indent=2))
    print(f"  wrote {args.out}")
    with open(args.out) as f:
        reloaded = DeploymentConfig.from_json(f.read())
    if reloaded != cfg:
        raise SystemExit("manifest on disk does not round-trip")
    print(f"  round-trip OK: backend={dep.backend.name} "
          f"plan={dep.plan.total_passes} passes "
          f"feature={dep.plan.feature_shape} wire={dep.wire_bytes}B "
          f"max_safe_batch={dep.max_safe_batch} "
          f"fleet={cfg.n_servers}x/{cfg.router} device={dep.device}")
    if args.verify:
        _verify_roundtrip(cfg, device=args.device)
        print("  verified: reloaded manifest reproduces identical encoder "
              "outputs and wire payloads")
    if args.real_fleet:
        _real_fleet_check(reloaded, n_requests=args.fleet_requests,
                          device=args.device)
    if args.scenario:
        _scenario_report(dep, args.scenario)


if __name__ == "__main__":
    main()


__all__ = ["CONFIG_VERSION", "Deployment", "DeploymentConfig", "ROUTERS"]
