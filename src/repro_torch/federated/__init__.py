"""The federated round of the port: runtime, strategies, wire stages, privacy."""
