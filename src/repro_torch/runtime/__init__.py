"""Runtime: the sim transport, the network simulator, fault tracking and
the peer lifecycle (numpy)."""
