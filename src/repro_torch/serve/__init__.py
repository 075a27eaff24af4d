"""Serving layer of the port: engines, router, scheduler, telemetry and
fault injection."""

from repro_torch.serve.engine import (ConversationalEngine, EngineTurn,
                                      make_lm_query_encoder)
from repro_torch.serve.faults import (CORRUPT_MODES, FaultError, FaultPlan,
                                     FaultSpec, FaultyShard, chaos_plan)
from repro_torch.serve.router import (AnswerValidationError, CircuitBreaker,
                                      RouterStats, ShardAnswer, ShardedRouter,
                                      validate_answer)
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.session import BatchedEngine, SessionManager
from repro_torch.serve.telemetry import ServeTelemetry, TurnSpans

__all__ = ["ConversationalEngine", "EngineTurn", "make_lm_query_encoder",
           "AnswerValidationError", "CircuitBreaker", "RouterStats",
           "ShardAnswer", "ShardedRouter", "validate_answer",
           "ContinuousScheduler", "BatchedEngine", "SessionManager",
           "ServeTelemetry", "TurnSpans", "CORRUPT_MODES", "FaultError",
           "FaultPlan", "FaultSpec", "FaultyShard", "chaos_plan"]
