"""Training path of the port: criterion, optimizer, schedule, EMA, weight
init and the single-device train step."""
