"""Trunks, subnets and the assembled MV3DNet."""
