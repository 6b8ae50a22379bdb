"""Host-side helpers of the port: configuration, the scan simulator,
trajectory evaluation and stage timers (numpy and the standard library)."""
