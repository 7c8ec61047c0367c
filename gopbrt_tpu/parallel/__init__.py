"""Device-mesh sharding: multi-device render and gradient steps."""
