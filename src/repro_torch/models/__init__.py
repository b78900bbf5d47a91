"""Models of the port (the paper's §4.1 hierarchical BNN)."""
