from .graph import AgentGraph, RAGAgentPipeline, create_agent_pipeline  # noqa: F401
from .state import AgentState  # noqa: F401
