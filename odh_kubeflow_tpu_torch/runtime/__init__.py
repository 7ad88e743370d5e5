"""Runtime utilities of the port's serving fleet: the circuit breaker
(`runtime.breaker`)."""
