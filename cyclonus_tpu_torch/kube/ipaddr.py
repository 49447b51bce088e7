"""IP / CIDR matching (reference: pkg/kube/ipaddress.go) plus the integer
encodings the tensor compiler uses (IPv4 as uint32 with prefix masks).

Go's net.ParseCIDR masks host bits (10.0.0.1/24 -> network 10.0.0.0/24);
ipaddress.ip_network(strict=False) does the same.
"""

from __future__ import annotations

import ipaddress
from typing import Optional, Tuple

from .netpol import IPBlock


def is_ip_in_cidr(ip: str, cidr: str) -> bool:
    """ipaddress.go:10-20.  Raises ValueError on malformed input (the
    reference returns an error which IPPeerMatcher.Allows panics on)."""
    try:
        net = ipaddress.ip_network(cidr, strict=False)
    except ValueError as e:
        raise ValueError(f"unable to parse CIDR '{cidr}': {e}") from e
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError as e:
        raise ValueError(f"unable to parse IP '{ip}': {e}") from e
    # Go's net.IPNet.Contains normalizes IPv4-mapped IPv6 (::ffff:a.b.c.d)
    # to IPv4 via To4 before comparing; mirror that.  Other cross-family
    # combinations don't match.
    if addr.version == 6 and net.version == 4:
        mapped = addr.ipv4_mapped
        if mapped is None:
            return False
        addr = mapped
    elif addr.version != net.version:
        return False
    return addr in net


def is_ip_address_match_for_ip_block(ip: str, ip_block: IPBlock) -> bool:
    """CIDR minus excepts (ipaddress.go:22-40)."""
    if not is_ip_in_cidr(ip, ip_block.cidr):
        return False
    for except_cidr in ip_block.except_:
        if is_ip_in_cidr(ip, except_cidr):
            return False
    return True


def make_ipv4_cidr(ip: str, bits: int) -> str:
    """Mask an IPv4 address down to /bits (ipaddress.go:42-46); used by the
    generator to derive ipblock cases from a live pod IP."""
    addr = ipaddress.ip_address(ip)
    net = ipaddress.ip_network(f"{addr}/{bits}", strict=False)
    return f"{net.network_address}/{bits}"


def ip_to_uint32(ip: str) -> Optional[int]:
    """IPv4 address as uint32 for the tensor encoding; IPv4-mapped IPv6
    (::ffff:a.b.c.d) normalizes to its IPv4 form like Go's To4 (and
    is_ip_in_cidr above); None for other non-IPv4 and unparseable input."""
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return None
    if addr.version == 6:
        mapped = addr.ipv4_mapped
        if mapped is None:
            return None
        addr = mapped
    return int(addr)


def cidr_to_base_and_prefix(cidr: str) -> Optional[Tuple[int, int]]:
    """IPv4 CIDR as (network-base uint32, prefix length); None for IPv6."""
    net = ipaddress.ip_network(cidr, strict=False)
    if net.version != 4:
        return None
    return int(net.network_address), net.prefixlen
