"""Peer models."""
