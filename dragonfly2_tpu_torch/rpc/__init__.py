"""Wire codec, mux helpers, resilience scopes and the inference RPC."""
