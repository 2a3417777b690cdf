"""The system under test: the port's objects for each kind that a
configuration (energy, circuit) or a cell (loss) names, built through its
public API (`models`, `inference`, `ops.paulis`).  The harness makes the
weights and hands them in; nothing here draws a random number."""
