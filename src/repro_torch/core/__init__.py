"""Paper core: CFN topology, VSRs, the power model (Eq. 1/2) with its delta
engine and per-service state operations, the placement solvers, the
online churn engine, and the declarative API."""
