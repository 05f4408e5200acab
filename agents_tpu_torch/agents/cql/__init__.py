from agents_tpu_torch.agents.cql.cql_sac_agent import (CqlSacAgent,
                                                       CqlSacAgentState,
                                                       CqlSacLossExtra)

__all__ = ["CqlSacAgent", "CqlSacAgentState", "CqlSacLossExtra"]
