"""Runtime: the sim transport, the network simulator, fault tracking,
the peer lifecycle, the sharding rules and the step analysis."""
from repro_torch.runtime.lifecycle import (CHURN_MODELS, ChurnModel,
                                           ChurnTick, LifecycleTick,
                                           MembershipEvent, PeerLifecycle,
                                           build_churn_model,
                                           build_lifecycle, load_trace,
                                           save_trace)
from repro_torch.runtime.sharding import (ShardPlan, make_shard_plan,
                                          state_shardings, batch_shardings)
