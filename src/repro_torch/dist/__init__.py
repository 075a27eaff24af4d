"""Corpus shards on devices behind the serving router."""
