"""Self-verifying wire frames for the async parameter server
(``pytorch_ps_mpi_tpu/resilience``). The fault injector, the resilient
worker and the supervisor belong to the scale-out and resilience item
(ROADMAP)."""
