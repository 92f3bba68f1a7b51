"""Host utilities: the bit array an aggregate commit's signer set rides,
the env knobs, telemetry, the service lifecycle (`libs.service`) and the
gRPC transports' shared codec (`libs.grpcutil`)."""
