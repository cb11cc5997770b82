"""Cost-model core of the port: the property taxonomy, the linear model, its
fit, the measurement protocol, automatic property extraction from an ATen
graph, and the measurement and held-out kernel sets."""
