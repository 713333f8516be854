"""Client and admission policies: load balancers, naming services, the
health check, the circuit breaker with its cluster recover policy, and
the concurrency limiters the batcher gates its queue with."""
