"""Synthetic graph generators and edge-list ingestion."""
