"""Serving subsystem of the port: the continuous-batching decode engine
(`serving.engine`), its HTTP front (`serving.server`) and its metric
families (`serving.metrics`)."""
