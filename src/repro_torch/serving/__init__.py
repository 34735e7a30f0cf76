"""Serving: the deployed half of the split-policy system (port of
``repro.serving``).

Module map
----------
``netsim``
    The bandwidth-shaped link (``ShapedLink``) and the scenario engine's
    adversarial links (``TraceLink``, ``MarkovLink``, ``LossyLink``,
    ``StochasticJitterLink``), each replaying bitwise from its seed on
    ``reset()``; ``LINK_KINDS`` / ``make_link`` name them for JSON.
``server``
    ``PolicyServer`` and the micro-batching ``BatchingPolicyServer`` (the
    measured t(B) curve, ``BatchServiceModel``), and the Table 6 queue
    simulators ``QueueSim`` (FIFO) and ``BatchQueueSim`` (batch-aware,
    serialised downlink).
``fleet``
    ``FleetQueueSim``: ``n_servers`` micro-batching servers behind a
    registered router (``ROUTERS``: ``round_robin`` / ``least_loaded`` /
    ``client_affinity``) on one shared uplink; ``max_clients`` and
    ``min_servers`` size a fleet.
``profiles``
    The device zoo (``DeviceProfile``, ``zoo``): paper-shaped t(B) curves
    of edge devices, model inputs rather than measurements.
``scenario``
    Named, seeded serving conditions (``Scenario``, ``SCENARIOS``) run
    through the fleet engine with a per-client adaptation controller
    (``ScenarioFleetSim``).
``client``
    ``EdgeClient`` (the deployment's ``edge_fn`` with single and batched
    measurement) and ``DecisionLoop`` (the paper's Figure-5 pipeline).
``realfleet``
    The fleet for real: ``RealFleet`` spawns ``n_servers``
    continuous-batching ``WorkerServer`` processes from one manifest on
    the deployment's device (localhost TCP, length-prefixed frames
    carrying the wire codecs' payloads bitwise), fronted by
    ``FleetClient``: the simulator's routers, per-request timeouts and
    re-routing retries.  ``run_load`` drives the Table 6 open-loop
    protocol against it; ``ShapingConfig`` / ``TokenBucket`` shape a
    worker's request ingress.  Construct with ``Deployment.fleet``.

The simulators are host-side float and numpy arithmetic fed with measured
times as Python floats: equal inputs and seeds give the reference's
numbers bit for bit.  The real fleet's framing is the reference's, byte
for byte, so its clients and workers interoperate with the reference's.
Training (``repro_torch.rl``) and ``Deployment.export_best`` (a
population's winner) feed this side the parameters it serves.
"""
from repro_torch.serving.netsim import (LINK_KINDS, LinkTrace, LossyLink,
                                        MarkovLink, ShapedLink,
                                        StochasticJitterLink, TraceLink,
                                        make_link, register_link_kind)
from repro_torch.serving.server import (BatchingPolicyServer, BatchQueueSim,
                                        BatchServiceModel, PolicyServer,
                                        QueueSim)
from repro_torch.serving.fleet import (FleetQueueSim, ROUTERS, get_router,
                                       register_router, router_names)
from repro_torch.serving.client import EdgeClient, DecisionLoop
from repro_torch.serving.profiles import (DEVICE_PROFILES, DeviceProfile,
                                          get_profile, register_profile, zoo)
from repro_torch.serving.scenario import (ADAPTATIONS, SCENARIOS,
                                          AdaptationMode, Scenario,
                                          ScenarioFleetSim, ScenarioReport,
                                          get_adaptation, get_scenario,
                                          register_adaptation,
                                          register_scenario, scenario_names)
from repro_torch.serving.realfleet import (FleetClient, FleetError,
                                           FleetTimeout, LoadReport,
                                           RealFleet, ShapingConfig,
                                           TokenBucket, WorkerServer,
                                           pack_payload, run_load,
                                           unpack_payload)

__all__ = ["ShapedLink", "LinkTrace", "TraceLink", "MarkovLink",
           "LossyLink", "StochasticJitterLink", "LINK_KINDS", "make_link",
           "register_link_kind", "PolicyServer", "BatchingPolicyServer",
           "BatchServiceModel", "BatchQueueSim", "QueueSim", "FleetQueueSim",
           "ROUTERS", "get_router", "register_router", "router_names",
           "EdgeClient", "DecisionLoop", "DeviceProfile", "DEVICE_PROFILES",
           "get_profile", "register_profile", "zoo", "Scenario",
           "SCENARIOS", "ScenarioFleetSim", "ScenarioReport",
           "AdaptationMode", "ADAPTATIONS", "register_scenario",
           "get_scenario", "scenario_names", "register_adaptation",
           "get_adaptation", "FleetClient", "FleetError", "FleetTimeout",
           "LoadReport", "RealFleet", "ShapingConfig", "TokenBucket",
           "WorkerServer", "pack_payload", "run_load", "unpack_payload"]
