"""Device ops on tensors: LPC synthesis and PCM DSP."""
