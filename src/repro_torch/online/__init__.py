"""Continuous online-training service (paper §1: "continuous integration of
massive volumes of new user interaction data into training pipelines").

The batch reproduction runs finite epochs over static sources; this package
turns it into a long-running daemon:

- ``bus``     — in-process event bus (bounded topics, per-event arrival
  timestamps, optional TCP transport) feeding ``Source.events(bus)``.
- ``shed``    — freshness-aware global shedding: when ingest outruns
  training, drop the oldest-by-arrival event across ALL stage queues.
- ``service`` — ``OnlineTrainer``: interleaves the train step with
  incremental vocab refresh (rank-stable ``fit_incremental`` + atomic state
  swap), periodic eval, and checkpoint rollover.
"""

from repro_torch.online.bus import BusClient, BusServer, EventBus, replay
from repro_torch.online.service import OnlineConfig, OnlineStats, OnlineTrainer
from repro_torch.online.shed import FreshnessShedder, ShedStats

__all__ = ["BusClient", "BusServer", "EventBus", "replay",
           "OnlineConfig", "OnlineStats", "OnlineTrainer",
           "FreshnessShedder", "ShedStats"]
