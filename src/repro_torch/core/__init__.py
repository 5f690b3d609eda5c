"""Paper core, batch path: CFN topology, VSRs, the power model (Eq. 1/2)
with its delta engine, the placement solvers, and the declarative API."""
