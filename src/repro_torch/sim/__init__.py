"""Deterministic scenario engine (port of ``repro.sim``): dynamic scenes
(object churn + tombstone deletes), user/network/fleet traces, one
discrete-event session loop.

A seeded declarative ``Scenario`` (object lifecycle events, user
trajectories, network traces, fleet churn, knob schedule) is driven by one
``ScenarioEngine`` loop that emits a structured, bit-replayable
``MetricsLog`` — equal to the reference's for the same Scenario.
``examples/network_drop_session.py`` and ``server.FleetSimulator`` are thin
wrappers over it.
"""
from repro_torch.core.runtime import FaultModel
from repro_torch.sim.scenario import (ClientSpec, CrashEvent, GridSpec,
                                      KnobEvent, NetTrace, ObjectEvent,
                                      PoseTrack, QueryPlan, Scenario,
                                      churn_scenario)
from repro_torch.sim.world import WorldState
from repro_torch.sim.engine import MetricsLog, ScenarioEngine, run_scenario
