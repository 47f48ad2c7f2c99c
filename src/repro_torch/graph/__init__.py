"""Host-side graph input of the port: `Graph` and the synthetic generators."""
from .storage import Graph, paper_example_graph

__all__ = ["Graph", "paper_example_graph"]
