"""Analysis of the port's operator: the state machines as data
(`analysis.machines`)."""
