"""Serving substrate of the port: continuous batching with straggler
hedging over the declarative query engine (``serving.batching``)."""
