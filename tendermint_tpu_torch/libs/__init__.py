"""Host utilities: the bit array an aggregate commit's signer set rides."""
