"""Binary/namelist IO and the synthetic forcing."""
