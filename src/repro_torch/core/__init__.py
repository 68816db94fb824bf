"""Federation controller substrate of the port — the paper's contribution.

Public API re-exports for the common path:

    from repro_torch.core import (
        pack_numeric, unpack_numeric, build_manifest,
        fedavg, Controller, Learner, Driver, FederationEnv,
    )
"""

from repro_torch.core.packing import (
    Manifest,
    TensorSpec,
    build_manifest,
    num_params,
    pack_bytes,
    pack_bytes_from_numeric,
    pack_numeric,
    round_up,
    tree_from_numpy,
    tree_to_numpy,
    unpack_bytes,
    unpack_numeric,
)
from repro_torch.core.aggregation import (
    coordinate_median,
    fedavg,
    masked_coordinate_median,
    masked_fedavg,
    masked_normalize,
    masked_staleness_average,
    masked_trimmed_mean,
    masked_weighted_average,
    staleness_weights,
    trimmed_mean,
    weighted_average,
)
from repro_torch.core.config import FederationConfig
from repro_torch.core.journal import EventJournal, RoundSummary
from repro_torch.core.metrics import Counter, Gauge, Histogram, Telemetry
from repro_torch.core.store import ArenaStore, ModelRecord, ModelStore
from repro_torch.core.scheduler import (
    AsyncProtocol,
    BufferedAsyncProtocol,
    DeadlineCohortProtocol,
    LearnerProfile,
    ProtocolPolicy,
    ReputationProtocol,
    SemiSyncProtocol,
    SyncProtocol,
    TrainTask,
)
from repro_torch.core.selection import SelectionPolicy, select_learners
from repro_torch.core.server_opt import ServerOptimizer, make_server_optimizer
from repro_torch.core.learner import EvalReport, Learner, LocalUpdate
from repro_torch.core.engine import (
    AggregateFired,
    DeadlineExpired,
    Dispatched,
    EngineStopped,
    Evaluated,
    LearnerQuarantined,
    RoundEngine,
    RoundTimings,
    UploadArrived,
    UploadClipped,
    UploadRejected,
    UploadRejectedError,
)
from repro_torch.core.controller import Controller
from repro_torch.core.faults import (
    ADVERSARIAL_FATES,
    FaultInjector,
    FaultSpec,
    FaultyChannel,
)
from repro_torch.core.driver import Driver, FederationEnv, TerminationCriteria
from repro_torch.core.transport import (
    Broadcast,
    Channel,
    ChannelStats,
    Envelope,
    RawUploadCodec,
    UploadEnvelope,
    get_upload_codec,
)

__all__ = [
    "Manifest", "TensorSpec", "build_manifest", "num_params",
    "pack_bytes", "pack_bytes_from_numeric", "pack_numeric", "round_up",
    "unpack_bytes", "unpack_numeric", "tree_from_numpy", "tree_to_numpy",
    "fedavg", "weighted_average", "masked_normalize",
    "masked_fedavg", "masked_staleness_average", "masked_weighted_average",
    "staleness_weights",
    "coordinate_median", "trimmed_mean", "masked_coordinate_median",
    "masked_trimmed_mean",
    "ModelRecord", "ModelStore", "ArenaStore",
    "SyncProtocol", "SemiSyncProtocol", "AsyncProtocol", "BufferedAsyncProtocol",
    "DeadlineCohortProtocol", "ReputationProtocol",
    "TrainTask", "ProtocolPolicy", "LearnerProfile",
    "SelectionPolicy", "select_learners",
    "ServerOptimizer", "make_server_optimizer",
    "Learner", "LocalUpdate", "EvalReport",
    "Controller", "RoundTimings", "RoundEngine",
    "Dispatched", "UploadArrived", "AggregateFired", "DeadlineExpired", "Evaluated",
    "EngineStopped",
    "UploadRejected", "UploadClipped", "LearnerQuarantined", "UploadRejectedError",
    "Telemetry", "Counter", "Gauge", "Histogram",
    "EventJournal", "RoundSummary",
    "Driver", "FederationEnv", "TerminationCriteria", "FederationConfig",
    "FaultSpec", "FaultInjector", "FaultyChannel", "ADVERSARIAL_FATES",
    "Broadcast", "Channel", "ChannelStats", "Envelope",
    "UploadEnvelope", "RawUploadCodec", "get_upload_codec",
]
