"""Admission policies: the concurrency limiters the batcher gates its
queue with."""
