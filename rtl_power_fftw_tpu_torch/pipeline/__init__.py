"""Host pipeline feeding the device step."""
